// One MCTS leaf expansion per board: apply the selected action, then
// compute the 32 V1 feature planes and the StandardSearch candidate mask of
// the new position.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/leaf_step.py::leaf_step
// (_make_kernel._kernel, _chain_stats_g).  The TPU kernel builds
// [384 x 384] chain-membership and adjacency matrices and runs them through
// the matrix unit.  Here one thread block holds one board, one thread per
// padded point (384 threads), and the board lives in shared memory:
//
//   - chain liberties: each empty point adds 1 (shared-memory atomicAdd) to
//     each distinct neighbouring chain id; each stone then reads its chain;
//   - liberties after a move at q, per colour, from per-chain 384-bit sets
//     (12 words): A_c = points adjacent to chain c, M_c = members of c,
//     E = empty points.  reach(q) = N(q) | A_c for the own chains c next to
//     q; open(q) = E | M_c for the opponent chains next to q that have one
//     liberty; libs = popcount(reach & open & ~{q}).  This is the counting
//     identity of ops/libs_after.py:11-15 written as sets;
//   - super-ko: each candidate hash against the min(placed, 64) valid ring
//     entries.
//
// What bounds it on an H100: memory.  A board reads about 7 KB of state and
// writes about 57 KB (the f32 planes dominate), some 64 KB per board, while
// its arithmetic is a few thousand integer operations.  The design keeps
// every intermediate (liberty tables, the bit sets) in shared memory, so
// device memory sees each input once and each output once; the plane
// stores are coalesced (consecutive threads, consecutive points).
//
// Phase A (apply_action) is a device function of its own so the env-step
// kernel (ops/env_step.py) can reuse it.
//
// Layout per board (ops/layout.py): stones, cid i32[384]; cxp i32[2][384];
// hist i32[2][128] (64 ring entries used); meta i32[8] = to_move, placed,
// move_count, pass_count, done, last0, last1, pad; hash i32[8] (words 0,1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 19;
constexpr int NN = N * N;    // 361 points
constexpr int NP = 384;      // padded point axis = threads per block
constexpr int RING = 64;     // super-ko ring entries
constexpr int HIST_W = 128;  // ring row width in the layout
constexpr int NW = NP / 32;  // words per point set
constexpr int PLANES = 32;

struct Board {
  int32_t st[NP];   // stones: 0 empty, 1 black, 2 white
  int32_t cid[NP];  // chain id (min member point)
  int32_t cx0[NP];  // per-point chain zobrist aggregate, word 0
  int32_t cx1[NP];  // word 1
};

struct Scalars {
  int me, opp, p, placing, frozen, is_pass, new_id;
  int cap_id[4], own_id[4];
  int nx0, nx1;   // aggregate of the merged chain
  int h0, h1;     // hash after the move
  int to_move2, placed2;
  int last0, last1;
};

struct Smem {
  Board in;                  // the board before the move
  Board out;                 // the board after the move
  int32_t clibs[NP];         // liberties by chain id
  int32_t plibs[NP];         // liberties of the chain holding each point
  int32_t hist0[RING];       // ring after the move, word 0
  int32_t hist1[RING];       // word 1
  uint32_t adj[NP][NW];      // A_c
  uint32_t mem[NP][NW];      // M_c
  uint32_t empty[NW];        // E
  Scalars s;
};

// Neighbour of q in direction k (left, right, up, down), -1 off the board.
__device__ __forceinline__ int nbr_of(int q, int k) {
  if (q < 0 || q >= NN) return -1;
  const int x = q % N;
  switch (k) {
    case 0: return x > 0 ? q - 1 : -1;
    case 1: return x < N - 1 ? q + 1 : -1;
    case 2: return q >= N ? q - N : -1;
    default: return q + N < NN ? q + N : -1;
  }
}

__device__ __forceinline__ bool is_stone(int v) { return v == 1 || v == 2; }
__device__ __forceinline__ bool chain_ok(int c) { return c >= 0 && c < NP; }

// Liberties of every chain (by id) and of the chain at every point.
// All threads of the block take part; ends synchronised.
__device__ void chain_liberties(const Board& b, int32_t* clibs,
                                int32_t* plibs) {
  const int q = threadIdx.x;
  clibs[q] = 0;
  __syncthreads();
  if (q < NN && b.st[q] == 0) {
    int ids[4];
    int n = 0;
    for (int k = 0; k < 4; ++k) {
      const int nb = nbr_of(q, k);
      if (nb < 0 || !is_stone(b.st[nb])) continue;
      const int c = b.cid[nb];
      bool dup = false;
      for (int j = 0; j < n; ++j) dup |= ids[j] == c;
      if (!dup) ids[n++] = c;
    }
    for (int j = 0; j < n; ++j)
      if (chain_ok(ids[j])) atomicAdd(&clibs[ids[j]], 1);
  }
  __syncthreads();
  const int c = b.cid[q];
  plibs[q] = (q < NN && b.st[q] > 0 && chain_ok(c)) ? clibs[c] : 0;
  __syncthreads();
}

// Phase A: play `action` (NN = pass) for the player to move on sm.in,
// writing sm.out, sm.hist0/1 and sm.s.  `meta`, `hash`, `hist` are the
// board's rows in device memory; `zob` is i32[4][384] (black w0, black w1,
// white w0, white w1).  Ends synchronised.
__device__ void apply_action(Smem& sm, const int32_t* meta,
                             const int32_t* hash, const int32_t* hist,
                             int action, const int32_t* __restrict__ zob) {
  const int q = threadIdx.x;
  chain_liberties(sm.in, sm.clibs, sm.plibs);
  Scalars& s = sm.s;
  if (q == 0) {
    const int me = meta[0];
    const int opp = 3 - me;
    const int frozen = meta[4] > 0;
    const int is_pass = action >= NN || frozen;
    const int p = action >= NN ? 0 : action;
    const int placing = !is_pass;
    int st_k[4], pl_k[4], cid_k[4], c0_k[4], c1_k[4];
    for (int k = 0; k < 4; ++k) {
      const int nb = nbr_of(p, k);
      st_k[k] = nb < 0 ? 3 : sm.in.st[nb];
      pl_k[k] = nb < 0 ? 0 : sm.plibs[nb];
      cid_k[k] = nb < 0 ? -1 : sm.in.cid[nb];
      c0_k[k] = nb < 0 ? 0 : sm.in.cx0[nb];
      c1_k[k] = nb < 0 ? 0 : sm.in.cx1[nb];
    }
    int new_id = p;
    int capx0 = 0, capx1 = 0, nx0, nx1;
    const int zrow = me == 1 ? 0 : 2;
    const int zp0 = __ldg(&zob[zrow * NP + p]);
    const int zp1 = __ldg(&zob[(zrow + 1) * NP + p]);
    nx0 = zp0;
    nx1 = zp1;
    for (int k = 0; k < 4; ++k) {
      const bool cap = st_k[k] == opp && pl_k[k] == 1;
      s.cap_id[k] = cap ? cid_k[k] : -7;
      const bool own = st_k[k] == me;
      s.own_id[k] = own ? cid_k[k] : -7;
      if (own && s.own_id[k] >= 0) new_id = min(new_id, s.own_id[k]);
    }
    for (int k = 0; k < 4; ++k) {
      bool dup_c = false, dup_o = false;
      for (int j = 0; j < k; ++j) {
        dup_c |= s.cap_id[j] == s.cap_id[k] && s.cap_id[j] >= 0;
        dup_o |= s.own_id[j] == s.own_id[k] && s.own_id[j] >= 0;
      }
      if (s.cap_id[k] >= 0 && !dup_c) {
        capx0 ^= c0_k[k];
        capx1 ^= c1_k[k];
      }
      if (s.own_id[k] >= 0 && !dup_o) {
        nx0 ^= c0_k[k];
        nx1 ^= c1_k[k];
      }
    }
    s.me = me;
    s.opp = opp;
    s.p = p;
    s.placing = placing;
    s.frozen = frozen;
    s.is_pass = is_pass;
    s.new_id = new_id;
    s.nx0 = nx0;
    s.nx1 = nx1;
    s.h0 = placing ? (hash[0] ^ zp0 ^ capx0) : hash[0];
    s.h1 = placing ? (hash[1] ^ zp1 ^ capx1) : hash[1];
    s.placed2 = meta[1] + placing;
    s.to_move2 = frozen ? me : opp;
    s.last0 = is_pass ? meta[5] : p;
    s.last1 = is_pass ? meta[6] : meta[5];
  }
  __syncthreads();

  const bool placing = s.placing;
  const int st = sm.in.st[q];
  const int cid = sm.in.cid[q];
  bool captured = false, member = false;
  for (int k = 0; k < 4; ++k) {
    captured |= s.cap_id[k] >= 0 && cid == s.cap_id[k];
    member |= s.own_id[k] >= 0 && cid == s.own_id[k];
  }
  captured = captured && placing && q < NN && st == s.opp;
  member = member && placing && st == s.me;
  const bool at_p = placing && q == s.p;
  const bool joined = member || at_p;
  sm.out.st[q] = at_p ? s.me : (captured ? 0 : st);
  sm.out.cid[q] = joined ? s.new_id : (captured ? q : cid);
  sm.out.cx0[q] = joined ? s.nx0 : (captured ? 0 : sm.in.cx0[q]);
  sm.out.cx1[q] = joined ? s.nx1 : (captured ? 0 : sm.in.cx1[q]);
  if (q < RING) {
    const int slot = ((meta[1] % RING) + RING) % RING;
    const bool hit = placing && q == slot;
    sm.hist0[q] = hit ? s.h0 : hist[q];
    sm.hist1[q] = hit ? s.h1 : hist[HIST_W + q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NP)
leaf_step_kernel(const int32_t* __restrict__ stones,
                 const int32_t* __restrict__ cid,
                 const int32_t* __restrict__ cxp,
                 const int32_t* __restrict__ hist,
                 const int32_t* __restrict__ meta,
                 const int32_t* __restrict__ hashw,
                 const int32_t* __restrict__ action,
                 const float* __restrict__ komi,
                 const int32_t* __restrict__ zob,
                 int32_t* __restrict__ stones_o, int32_t* __restrict__ cid_o,
                 int32_t* __restrict__ cxp_o, int32_t* __restrict__ hist_o,
                 int32_t* __restrict__ meta_o, int32_t* __restrict__ hash_o,
                 float* __restrict__ feats_o, uint8_t* __restrict__ cand_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int q = threadIdx.x;

  const int32_t* meta_b = meta + b * 8;
  const int32_t* hash_b = hashw + b * 8;
  const int32_t* hist_b = hist + b * 2 * HIST_W;
  sm.in.st[q] = stones[b * NP + q];
  sm.in.cid[q] = cid[b * NP + q];
  sm.in.cx0[q] = cxp[b * 2 * NP + q];
  sm.in.cx1[q] = cxp[b * 2 * NP + NP + q];
  __syncthreads();

  // ---- phase A: the move ------------------------------------------------
  apply_action(sm, meta_b, hash_b, hist_b, action[b], zob);
  const Scalars& s = sm.s;

  stones_o[b * NP + q] = sm.out.st[q];
  cid_o[b * NP + q] = sm.out.cid[q];
  cxp_o[b * 2 * NP + q] = sm.out.cx0[q];
  cxp_o[b * 2 * NP + NP + q] = sm.out.cx1[q];
  if (q < HIST_W) {
    hist_o[b * 2 * HIST_W + q] = q < RING ? sm.hist0[q] : hist_b[q];
    hist_o[b * 2 * HIST_W + HIST_W + q] =
        q < RING ? sm.hist1[q] : hist_b[HIST_W + q];
  }
  if (q < 8) {
    const int mc = meta_b[2], pc = meta_b[3];
    int v;
    switch (q) {
      case 0: v = s.to_move2; break;
      case 1: v = s.placed2; break;
      case 2: v = s.frozen ? mc : mc + 1; break;
      case 3: v = s.frozen ? pc : (s.is_pass ? pc + 1 : 0); break;
      case 4: v = s.frozen ? 1 : ((s.is_pass && pc + 1 >= 2) ? 1 : 0); break;
      case 5: v = s.last0; break;
      case 6: v = s.last1; break;
      default: v = meta_b[7]; break;
    }
    meta_o[b * 8 + q] = v;
    hash_o[b * 8 + q] = q == 0 ? s.h0 : (q == 1 ? s.h1 : hash_b[q]);
  }
  const int done2 = s.frozen || (s.is_pass && meta_b[3] + 1 >= 2);

  // ---- phase B: features and candidates of the new position ------------
  const Board& nb = sm.out;
  chain_liberties(nb, sm.clibs, sm.plibs);
  for (int w = 0; w < NW; ++w) {
    sm.adj[q][w] = 0u;
    sm.mem[q][w] = 0u;
  }
  if (q < NW) sm.empty[q] = 0u;
  __syncthreads();
  const uint32_t qbit = 1u << (q & 31);
  const int qw = q >> 5;
  if (q < NN) {
    const int v = nb.st[q];
    if (v == 0) {
      atomicOr(&sm.empty[qw], qbit);
    } else if (is_stone(v) && chain_ok(nb.cid[q])) {
      atomicOr(&sm.mem[nb.cid[q]][qw], qbit);
    }
    for (int k = 0; k < 4; ++k) {
      const int n = nbr_of(q, k);
      if (n >= 0 && is_stone(nb.st[n]) && chain_ok(nb.cid[n]))
        atomicOr(&sm.adj[nb.cid[n]][qw], qbit);
    }
  }
  __syncthreads();

  const int t2 = s.to_move2;
  const int o2 = 3 - t2;
  const bool valid = q < NN;
  int st_k[4], pl_k[4], cid_k[4], c0_k[4], c1_k[4], nb_k[4];
  for (int k = 0; k < 4; ++k) {
    const int n = nbr_of(q, k);
    nb_k[k] = n;
    st_k[k] = n < 0 ? 3 : nb.st[n];
    pl_k[k] = n < 0 ? 0 : sm.plibs[n];
    cid_k[k] = n < 0 ? -1 : nb.cid[n];
    c0_k[k] = n < 0 ? 0 : nb.cx0[n];
    c1_k[k] = n < 0 ? 0 : nb.cx1[n];
  }
  const bool empty2 = valid && nb.st[q] == 0;
  bool pseudo[3] = {false, false, false};
  int libs_if[3] = {0, 0, 0};
  for (int color = 1; color <= 2; ++color) {
    bool has_empty = false, own_ok = false, cap_ok = false;
    for (int k = 0; k < 4; ++k) {
      has_empty |= st_k[k] == 0;
      own_ok |= st_k[k] == color && pl_k[k] >= 2;
      cap_ok |= st_k[k] == 3 - color && pl_k[k] == 1;
    }
    pseudo[color] = empty2 && (has_empty || own_ok || cap_ok);
    if (!pseudo[color]) continue;
    uint32_t reach[NW], open[NW];
    for (int w = 0; w < NW; ++w) {
      reach[w] = 0u;
      open[w] = sm.empty[w];
    }
    for (int k = 0; k < 4; ++k) {
      const int n = nb_k[k];
      if (n < 0) continue;
      reach[n >> 5] |= 1u << (n & 31);
      const int c = cid_k[k];
      if (!chain_ok(c)) continue;
      if (st_k[k] == color) {
        for (int w = 0; w < NW; ++w) reach[w] |= sm.adj[c][w];
      } else if (st_k[k] == 3 - color && sm.clibs[c] == 1) {
        for (int w = 0; w < NW; ++w) open[w] |= sm.mem[c][w];
      }
    }
    reach[qw] &= ~qbit;
    int count = 0;
    for (int w = 0; w < NW; ++w) count += __popc(reach[w] & open[w]);
    libs_if[color] = count;
  }

  // super-ko for the player to move: candidate hash against the ring
  bool in_ring = false;
  if (pseudo[t2]) {
    int hc0 = s.h0 ^ __ldg(&zob[(t2 == 1 ? 0 : 2) * NP + q]);
    int hc1 = s.h1 ^ __ldg(&zob[(t2 == 1 ? 1 : 3) * NP + q]);
    for (int k = 0; k < 4; ++k) {
      const bool cap = st_k[k] == o2 && pl_k[k] == 1;
      bool dup = false;
      for (int j = 0; j < k; ++j)
        dup |= st_k[j] == o2 && pl_k[j] == 1 && cid_k[j] == cid_k[k];
      if (cap && !dup) {
        hc0 ^= c0_k[k];
        hc1 ^= c1_k[k];
      }
    }
    const int nvalid = min(s.placed2, RING);
    for (int i = 0; i < nvalid; ++i)
      in_ring |= hc0 == sm.hist0[i] && hc1 == sm.hist1[i];
  }
  const bool ko = in_ring && pseudo[t2];
  const int any_ko = __syncthreads_or(ko);

  if (valid)
    cand_o[b * NN + q] = (pseudo[t2] && !in_ring && !done2) ? 1 : 0;

  // ---- planes (features.rs:104-148 order) -------------------------------
  float* f = feats_o + (size_t)b * PLANES * NP + q;
  const float kc = fminf(fmaxf(0.5f + 0.5f * komi[b] / 7.5f, 0.0f), 1.0f);
  const int pl2 = sm.plibs[q];
  const int own_libs = (valid && nb.st[q] == t2) ? pl2 : 0;
  const int opp_libs = (valid && nb.st[q] == o2) ? pl2 : 0;
  const int lif_t = pseudo[t2] ? libs_if[t2] : 0;
  const int lif_o = pseudo[o2] ? libs_if[o2] : 0;
  const float on = valid ? 1.0f : 0.0f;
  f[0 * NP] = on * (t2 == 1 ? kc : 0.0f);
  f[1 * NP] = on * (t2 == 1 ? 0.0f : kc);
  f[2 * NP] = on * (any_ko ? 1.0f : 0.0f);
  f[3 * NP] = (valid && q == s.last0 && s.last0 < NN) ? 1.0f : 0.0f;
  f[4 * NP] = (valid && q == s.last1 && s.last1 < NN) ? 1.0f : 0.0f;
  for (int k = 1; k <= 6; ++k) {
    f[(4 + k) * NP] = own_libs >= k ? 1.0f : 0.0f;
    f[(10 + k) * NP] = lif_t >= k ? 1.0f : 0.0f;
    f[(16 + k) * NP] = opp_libs >= k ? 1.0f : 0.0f;
    f[(22 + k) * NP] = lif_o >= k ? 1.0f : 0.0f;
  }
  f[29 * NP] = ko ? 1.0f : 0.0f;
  f[30 * NP] = 0.0f;
  f[31 * NP] = 0.0f;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block uses.
int dg_leaf_step_smem_bytes() { return (int)sizeof(Smem); }

// Launches one block per board on `stream`; returns cudaGetLastError().
int dg_leaf_step(const void* stones, const void* cid, const void* cxp,
                 const void* hist, const void* meta, const void* hashw,
                 const void* action, const void* komi, const void* zob,
                 void* stones_o, void* cid_o, void* cxp_o, void* hist_o,
                 void* meta_o, void* hash_o, void* feats_o, void* cand_o,
                 int batch, void* stream) {
  // the shared-memory opt-in is per device; set it once on each (a call
  // made while a CUDA graph captures the stream then only launches)
  static bool configured[64] = {};
  const int smem = (int)sizeof(Smem);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(
        leaf_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  leaf_step_kernel<<<batch, NP, smem, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (const int32_t*)cxp,
      (const int32_t*)hist, (const int32_t*)meta, (const int32_t*)hashw,
      (const int32_t*)action, (const float*)komi, (const int32_t*)zob,
      (int32_t*)stones_o, (int32_t*)cid_o, (int32_t*)cxp_o,
      (int32_t*)hist_o, (int32_t*)meta_o, (int32_t*)hash_o,
      (float*)feats_o, (uint8_t*)cand_o);
  return (int)cudaGetLastError();
}

}  // extern "C"
