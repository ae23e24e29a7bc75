// Ladder feature planes 30 (capture) and 31 (escape) for the player to move,
// with the reference's exact branching ladder reading (ladder.rs:53-178).
//
// Replaces the Pallas TPU kernel
// dream_go_tpu/ops/ladder_kernel.py::ladder_planes_kernel (_kernel,
// _chase_group, _place, _plibs_full, _valid_at).  The TPU kernel runs one
// board per grid step with eight chase lanes as the sublanes of [8, 384]
// rows and keeps three [8, 8, 384] int32 branch stacks in VMEM (294,912
// bytes, more than the 227 KB of shared memory a Hopper block can have).
// Here the candidates of a board are independent chases, so:
//
//   - one thread block per board, eight warps; every capture start and
//     every escape start of the board is one job, dealt round-robin over
//     the warps.  A warp runs its chase alone, its 32 threads sweeping the
//     361 points (12 points each) for every board-wide step;
//   - each warp owns a board copy and an 8-deep branch stack in shared
//     memory, narrowed: int8 stones, int16 chain ids (the stack holds no
//     liberty table: a pop recounts it), about 11.7 KB a warp and 99 KB a
//     block (two blocks per SM);
//   - liberties by chain id are recounted after every placement: each empty
//     point adds one (shared-memory atomicAdd) to each distinct neighbouring
//     chain.  The chase compares only small counts (1, 2, >= 2, >= 3);
//   - an escape start places the escaping stone, then runs its <= 4
//     counter-attack chases one after another on a fresh copy of that board
//     and stops at the first that captures (all of them must fail).
//
// Every index stays in range by construction: chain ids are sanitised to
// [0, 361) on load and stay there (a merge takes the smallest member, a
// capture resets to the point), neighbours come from nbr() (-1 off the
// board), the stack pointer never reaches stack_cap <= STACK_CAP, and a
// chase stops after `budget` rungs.  The bounds are fail-safe as in the
// reference: an exhausted budget or a full stack loses the capture.
//
// The direction order is go/topology.NBR's (up, left, right, down): the
// chase takes the FIRST qualifying extension and branch in this order.
//
// What bounds it on an H100: latency, not memory.  A board reads 3 KB and
// writes 722 bytes; the work is a data-dependent chain of rungs (each a few
// sweeps over the board with warp syncs between them), so the time of a
// batch is that of its longest chase.
//
// Inputs per board (ops/layout.py): stones, cid i32[384]; to_move i32.
// Outputs: capture, escape bool[361].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 19;
constexpr int NN = N * N;    // 361 points
constexpr int NP = 384;      // padded point axis of the layout
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STACK_CAP = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Lane {
  int32_t libs[NP];              // liberties by chain id
  int16_t cid[NP];
  int16_t scid[STACK_CAP][NP];
  int16_t satk[STACK_CAP];
  int8_t st[NP];
  int8_t sst[STACK_CAP][NP];
};

struct Smem {
  int32_t libs0[NP];             // the board as given
  int16_t cid0[NP];
  int16_t cap_list[NP];
  int16_t esc_list[NP];
  int8_t st0[NP];
  uint8_t cap_flag[NP];          // candidates, then results
  uint8_t esc_flag[NP];
  int ncap, nesc;
  Lane lane[WARPS];
};

// Neighbour of q in direction k (up, left, right, down), -1 off the board.
__device__ __forceinline__ int nbr(int q, int k) {
  const int x = q % N;
  switch (k) {
    case 0: return q >= N ? q - N : -1;
    case 1: return x > 0 ? q - 1 : -1;
    case 2: return x < N - 1 ? q + 1 : -1;
    default: return q + N < NN ? q + N : -1;
  }
}

__device__ __forceinline__ bool is_stone(int v) { return v == 1 || v == 2; }

// Each empty point in [first, NN) by `stride` adds one to each distinct
// neighbouring chain.  The caller zeroes `libs` and synchronises.
__device__ void add_liberties(const int8_t* st, const int16_t* cid,
                              int32_t* libs, int first, int stride) {
  for (int q = first; q < NN; q += stride) {
    if (st[q] != 0) continue;
    int ids[4];
    int n = 0;
    for (int k = 0; k < 4; ++k) {
      const int y = nbr(q, k);
      if (y < 0 || !is_stone(st[y])) continue;
      const int c = cid[y];
      bool dup = false;
      for (int j = 0; j < n; ++j) dup |= ids[j] == c;
      if (!dup) ids[n++] = c;
    }
    for (int j = 0; j < n; ++j) atomicAdd(&libs[ids[j]], 1);
  }
}

// Recount a lane's liberty table; the warp ends synchronised.
__device__ void recount(Lane& L, int ln) {
  for (int q = ln; q < NP; q += 32) L.libs[q] = 0;
  __syncwarp();
  add_liberties(L.st, L.cid, L.libs, ln, 32);
  __syncwarp();
}

__device__ __forceinline__ int libs_at(const Lane& L, int y) {
  return is_stone(L.st[y]) ? L.libs[L.cid[y]] : 0;
}

// board_fast.rs:216-243 legality of `color` at p (p < 0: never).
__device__ bool valid_at(const Lane& L, int color, int p) {
  if (p < 0 || L.st[p] != 0) return false;
  for (int k = 0; k < 4; ++k) {
    const int y = nbr(p, k);
    if (y < 0) continue;
    const int v = L.st[y];
    if (v == 0) return true;
    const int l = L.libs[L.cid[y]];
    if ((v == color && l >= 2) || (v == 3 - color && l == 1)) return true;
  }
  return false;
}

// Play `color` at p: capture adjacent opponent chains in atari, merge own
// chains under the smallest id, recount.  Warp-wide; ends synchronised.
__device__ void place(Lane& L, int color, int p, int ln) {
  const int opp = 3 - color;
  int cap_id[4], own_id[4];
  int new_id = p;
  for (int k = 0; k < 4; ++k) {
    cap_id[k] = own_id[k] = -1;
    const int y = nbr(p, k);
    if (y < 0) continue;
    const int v = L.st[y];
    const int c = L.cid[y];
    if (v == opp && L.libs[c] == 1) cap_id[k] = c;
    if (v == color) {
      own_id[k] = c;
      new_id = min(new_id, c);
    }
  }
  __syncwarp();
  for (int q = ln; q < NN; q += 32) {
    if (q == p) {
      L.st[q] = (int8_t)color;
      L.cid[q] = (int16_t)new_id;
      continue;
    }
    const int v = L.st[q];
    const int c = L.cid[q];
    if (v == opp && (c == cap_id[0] || c == cap_id[1] || c == cap_id[2] ||
                     c == cap_id[3])) {
      L.st[q] = 0;
      L.cid[q] = (int16_t)q;
    } else if (v == color && (c == own_id[0] || c == own_id[1] ||
                              c == own_id[2] || c == own_id[3])) {
      L.cid[q] = (int16_t)new_id;
    }
  }
  __syncwarp();
  recount(L, ln);
}

// Empty neighbours of e other than a (the exploration-order heuristic).
__device__ int after_libs(const Lane& L, int a, int e) {
  int n = 0;
  for (int k = 0; k < 4; ++k) {
    const int y = nbr(e, k);
    n += (y >= 0 && L.st[y] == 0 && y != a) ? 1 : 0;
  }
  return n;
}

__device__ void save(Lane& L, int slot, int ln) {
  for (int q = ln; q < NN; q += 32) {
    L.sst[slot][q] = L.st[q];
    L.scid[slot][q] = L.cid[q];
  }
  __syncwarp();
}

__device__ void restore(Lane& L, int slot, int ln) {
  for (int q = ln; q < NN; q += 32) {
    L.st[q] = L.sst[slot][q];
    L.cid[q] = L.scid[slot][q];
  }
  __syncwarp();
  recount(L, ln);
}

__device__ void load_root(const Smem& sm, Lane& L, int ln) {
  for (int q = ln; q < NN; q += 32) {
    L.st[q] = sm.st0[q];
    L.cid[q] = sm.cid0[q];
    L.libs[q] = sm.libs0[q];
  }
  __syncwarp();
}

// The exact DFS of go/ladder.py::run_chases for one lane: `color` attacks
// at `attack` on the lane's board (its liberty table current).  True when
// some line captures within `budget` rungs.
__device__ bool chase(Lane& L, int color, int attack, int budget,
                      int stack_cap, int ln) {
  const int opp = 3 - color;
  int sp = 0;
  for (int depth = 0; depth < budget; ++depth) {
    // the attacker plays; the first adjacent defender chain in atari that
    // cannot counter-capture and whose liberty is playable extends
    place(L, color, attack, ln);
    int ext = -1;
    for (int k = 0; k < 4 && ext < 0; ++k) {
      const int y = nbr(attack, k);
      if (y < 0 || L.st[y] != opp) continue;
      const int c = L.cid[y];
      if (L.libs[c] != 1) continue;
      int lib = NN;
      bool counter = false;
      for (int q = ln; q < NN; q += 32) {
        if (L.st[q] != opp || L.cid[q] != c) continue;
        for (int j = 0; j < 4; ++j) {
          const int z = nbr(q, j);
          if (z < 0) continue;
          const int v = L.st[z];
          if (v == 0) lib = min(lib, z);
          else if (v == color && L.libs[L.cid[z]] == 1) counter = true;
        }
      }
      lib = __reduce_min_sync(FULL, lib);
      counter = __any_sync(FULL, counter);
      if (!counter && lib < NN && valid_at(L, opp, lib)) ext = lib;
    }
    int status;  // 0 = branch, 1 = captured, 2 = this line fails
    if (ext < 0) {
      status = 2;
    } else {
      place(L, opp, ext, ln);
      const int dl = L.libs[L.cid[ext]];
      bool self_atari = false;
      for (int k = 0; k < 4; ++k) {
        const int y = nbr(ext, k);
        self_atari |= y >= 0 && L.st[y] == color && libs_at(L, y) == 1;
      }
      status = dl <= 1 ? 1 : ((dl >= 3 || self_atari) ? 2 : 0);
    }
    if (status == 1) return true;
    int c1 = -1, c2 = -1;
    if (status == 0) {
      for (int k = 0; k < 4; ++k) {
        const int y = nbr(ext, k);
        if (!valid_at(L, color, y)) continue;
        if (c1 < 0) c1 = y;
        else if (c2 < 0) c2 = y;
      }
      if (c1 >= 0 && c2 >= 0 &&
          after_libs(L, c2, c1) > after_libs(L, c1, c2)) {
        const int t = c1;
        c1 = c2;
        c2 = t;
      }
    }
    if (status == 0 && c1 >= 0) {
      if (c2 >= 0 && sp < stack_cap) {
        save(L, sp, ln);
        if (ln == 0) L.satk[sp] = (int16_t)c2;
        ++sp;
      }
      attack = c1;
    } else if (sp > 0) {
      --sp;
      restore(L, sp, ln);
      attack = L.satk[sp];
    } else {
      return false;
    }
  }
  return false;
}

__global__ void __launch_bounds__(THREADS)
ladder_planes_kernel(const int32_t* __restrict__ stones,
                     const int32_t* __restrict__ cid,
                     const int32_t* __restrict__ to_move, int budget,
                     int stack_cap, uint8_t* __restrict__ cap_o,
                     uint8_t* __restrict__ esc_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int ln = t & 31;
  const int color = to_move[b] == 2 ? 2 : 1;
  const int opp = 3 - color;

  for (int q = t; q < NP; q += THREADS) {
    const int v = q < NN ? stones[b * NP + q] : 0;
    const int c = cid[b * NP + q];
    const bool stone = q < NN && is_stone(v);
    sm.st0[q] = (int8_t)(stone ? v : 0);
    sm.cid0[q] = (int16_t)(stone && c >= 0 && c < NN ? c : (q < NN ? q : 0));
    sm.libs0[q] = 0;
  }
  __syncthreads();
  add_liberties(sm.st0, sm.cid0, sm.libs0, t, THREADS);
  __syncthreads();

  // candidates for the player to move: pseudo-legal points next to an
  // opponent chain on two liberties (capture) / an own chain in atari
  // (escape)
  for (int q = t; q < NP; q += THREADS) {
    bool cap = false, esc = false;
    if (q < NN && sm.st0[q] == 0) {
      bool ok = false;
      for (int k = 0; k < 4; ++k) {
        const int y = nbr(q, k);
        if (y < 0) continue;
        const int v = sm.st0[y];
        const int l = is_stone(v) ? sm.libs0[sm.cid0[y]] : 0;
        ok |= v == 0 || (v == color && l >= 2) || (v == opp && l == 1);
        cap |= v == opp && l == 2;
        esc |= v == color && l == 1;
      }
      cap &= ok;
      esc &= ok;
    }
    sm.cap_flag[q] = cap;
    sm.esc_flag[q] = esc;
  }
  __syncthreads();
  if (w == 0) {  // compact both candidate sets, in point order
    int nc = 0, ne = 0;
    const unsigned below = (1u << ln) - 1u;
    for (int q0 = 0; q0 < NN; q0 += 32) {
      const int q = q0 + ln;
      const bool fc = q < NN && sm.cap_flag[q];
      const bool fe = q < NN && sm.esc_flag[q];
      const unsigned mc = __ballot_sync(FULL, fc);
      const unsigned me = __ballot_sync(FULL, fe);
      if (fc) sm.cap_list[nc + __popc(mc & below)] = (int16_t)q;
      if (fe) sm.esc_list[ne + __popc(me & below)] = (int16_t)q;
      nc += __popc(mc);
      ne += __popc(me);
    }
    if (ln == 0) {
      sm.ncap = nc;
      sm.nesc = ne;
    }
  }
  __syncthreads();
  for (int q = t; q < NP; q += THREADS) {
    sm.cap_flag[q] = 0;
    sm.esc_flag[q] = 0;
  }
  __syncthreads();

  Lane& L = sm.lane[w];
  const int ncap = sm.ncap;
  const int njobs = ncap + sm.nesc;
  for (int j = w; j < njobs; j += WARPS) {
    if (j < ncap) {
      const int p = sm.cap_list[j];
      load_root(sm, L, ln);
      const bool captured = chase(L, color, p, budget, stack_cap, ln);
      if (ln == 0 && captured) sm.cap_flag[p] = 1;
    } else {
      // escape: extend to q (the chain must then have two liberties),
      // and every playable counter-attack must fail as a ladder
      const int q = sm.esc_list[j - ncap];
      load_root(sm, L, ln);
      place(L, color, q, ln);
      bool escaped = L.libs[L.cid[q]] == 2;
      bool fresh = true;
      for (int k = 0; k < 4 && escaped; ++k) {
        const int a = nbr(q, k);
        if (a < 0) continue;
        if (!fresh) {
          load_root(sm, L, ln);
          place(L, color, q, ln);
        }
        if (!valid_at(L, opp, a)) {
          fresh = true;
          continue;
        }
        fresh = false;
        escaped = !chase(L, opp, a, budget, stack_cap, ln);
      }
      if (ln == 0 && escaped) sm.esc_flag[q] = 1;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int q = t; q < NN; q += THREADS) {
    cap_o[b * NN + q] = sm.cap_flag[q];
    esc_o[b * NN + q] = sm.esc_flag[q];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block uses.
int dg_ladder_planes_smem_bytes() { return (int)sizeof(Smem); }

// Launches one block per board on `stream`; returns cudaGetLastError().
// `stack_cap` is clamped to [0, STACK_CAP].
int dg_ladder_planes(const void* stones, const void* cid, const void* to_move,
                     int budget, int stack_cap, void* cap_o, void* esc_o,
                     int batch, void* stream) {
  // the shared-memory opt-in is per device; set it once on each (a call
  // made while a CUDA graph captures the stream then only launches)
  static bool configured[64] = {};
  const int smem = (int)sizeof(Smem);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(ladder_planes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  stack_cap = stack_cap < 0 ? 0 : (stack_cap > STACK_CAP ? STACK_CAP
                                                         : stack_cap);
  ladder_planes_kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (const int32_t*)to_move,
      budget < 0 ? 0 : budget, stack_cap, (uint8_t*)cap_o, (uint8_t*)esc_o);
  return (int)cudaGetLastError();
}

}  // extern "C"
