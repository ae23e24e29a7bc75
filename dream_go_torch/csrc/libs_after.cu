// Per-point feature ingredients of the V1 planes: the exact liberties after
// playing each point, for black and for white; the liberties of the chain
// holding each point; pseudo-legality for each colour.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/libs_after.py::_kernel
// (behind liberties_after_both and board_features_raw).  The TPU kernel
// builds [384 x 384] chain-membership matrices and counts through two
// matrix products per colour.  Here the counting identity of
// ops/libs_after.py:11-15,
//
//   libs_if[p] = #{e != p : (e empty or captured by playing p)
//                           and (e adjacent to p or to an own chain
//                                adjacent to p)},
//
// is evaluated at every point, stones included (the values at points that
// are not pseudo-legal are the identity's, as in the TPU kernel): with
// E = the empty points, M_c = the members of chain c, A_c = the points next
// to c, and C, D = the own chains next to p and the opponent chains next to
// p with one liberty, it is |(N(p) | A_C) & (E | M_D) & ~{p}|.
//
// What bounds it on an H100: a board reads 3 KB and writes 7 KB, and its
// arithmetic is a few thousand integer operations, so the byte bound is
// far below what a board's chain of dependent steps (load, member words,
// liberties, counts, stores) takes; the time is latency unless many boards
// overlap on each SM, and then instruction issue.  So each board has a
// block of four warps (at most 64 registers and ~24 KB of shared memory:
// eight boards an SM, the bench's B=1024 in one wave), which split its
// points three 32-point slots each (q = lane + 32 j, j = warp + 4 jj),
// meet at three block barriers and otherwise work with warp primitives:
//
//   0. every global read at entry (stones and chain ids, 4-byte coalesced);
//      each point's code in shared memory (a stone's colour << 9 | its
//      chain id, 0 for an empty point), the empty points as ballot words
//      (word j holds the points 32 j .. 32 j + 31); a chain's root (its
//      least point, the chain-id convention) clears its `info` word;
//   1. each point's four neighbour codes, read once and kept (`nbr`); per
//      slot one __match_any_sync on the stones' codes groups each chain's
//      stones of the word, whose leader stores the group as M_c's word.  No
//      table is zeroed: a chain is connected and a step moves at most 19
//      points, so its words lo..hi are all written, and no other is read;
//   2. each chain's exact liberties: an empty point is counted by the
//      chain's stone in its first direction holding the chain, the
//      group's counts summed by three ballots, and the leader adds the sum
//      and the word's bit of the chain's occupancy (info bits 16..27) with
//      one atomicAdd per chain and word;
//   3. per point, its four neighbours classified once as 4-bit masks shared
//      by both colours (empty, black, white, one liberty, two or more,
//      first direction of each chain); pseudo-legality from three of them;
//      and per colour a direct count where the identity allows one: no own
//      chain: |N_E(p)| + |N(p) & M_D|; one own chain c and no capture:
//      libs(c) - [p empty] + #{e in N_E(p) : no neighbour of e is in c};
//   4. the rest (two or more own chains, or an own chain and a capture:
//      ~10% of a mid-game board's points and colours) become a warp's
//      tasks, dealt one a lane: the union over the words its reach spans,
//      with reach = dilate({p} | M_C) (the dilation of a union is the union
//      of the dilations, so one dilation a word) and open = E | M_D;
//   5. the five rows stored as 4-byte coalesced stores (the rows are 1,444
//      bytes, only 4-byte aligned), a union task's count by its lane.
//
// Built with -DDG_CHECK (ops/build.py, its own library), a device-side
// assert guards every shared and global index, every chain id used as a
// row (a stone's chain id must be its chain's root: a stone of its colour
// that is its own chain id and no later than the stone), each chain's
// word occupancy and every word span of a union.
//
// Inputs per board (ops/layout.py): stones, cid i32[384].  Output
// i32[5][361]: libs_if_black, libs_if_white, point_libs, pseudo_black,
// pseudo_white.

#include "go_board.cuh"

#ifdef DG_CHECK
#include <cassert>
#define DG_ASSERT(cond) assert(cond)
#else
#define DG_ASSERT(cond) ((void)0)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 5;
constexpr int WARPS = 4;                 // warps a board (and a block)
constexpr int THREADS = 32 * WARPS;
constexpr int SPT = NW / WARPS;          // 32-point slots a thread
constexpr int COLOUR = 9;                // a code: colour << COLOUR | chain id
constexpr int CHAIN = (1 << COLOUR) - 1;
constexpr int STONE = 1 << COLOUR;       // the least code of a stone
constexpr int OFF = 0x7fff;              // the code of a point off the board
constexpr int LIBS = 0xffff;             // info: liberties (bits 0..15)
constexpr int OCC = 16;                  // info: word occupancy from bit 16

// A board in shared memory.  Rows of `mem` and words of `info` are those of
// chain roots only; a root's `mem` row is valid on its occupied words only.
struct __align__(16) Smem {
  uint32_t mem[NP][NW];      // M_c, by root c
  uint2 nbr[NP];             // the four neighbour codes of each point
  int32_t info[NP];          // by root: liberties | occupied words << OCC
  uint32_t task[WARPS][32];  // a warp's union tasks of one round
  int16_t code[NP];          // stone: colour << COLOUR | chain id; else 0
  uint32_t empty[NW];        // the empty points as words of 32 points
  uint32_t not_left[NW];     // the points of a word not in column 0
  uint32_t not_right[NW];    // ... not in column N - 1
};

// The point offset of neighbour k (left, right, up, down: nbr_of's order).
__device__ __forceinline__ int offset_of(int k) {
  return (k & 1 ? 1 : -1) * (k & 2 ? N : 1);
}

// Bit k: the point q has a neighbour k on the board.
__device__ __forceinline__ unsigned on_board4(int q) {
  const int x = q % N;
  return q < NN ? ((x > 0 ? 1u : 0u) | (x < N - 1 ? 2u : 0u) |
                   (q >= N ? 4u : 0u) | (q + N < NN ? 8u : 0u))
                : 0u;
}

// The code of neighbour k from a point's packed neighbour codes.
__device__ __forceinline__ int code_of(uint2 n, int k) {
  return (int)(((k & 2 ? n.y : n.x) >> ((k & 1) * 16)) & 0xffffu);
}

__device__ __forceinline__ bool is_stone_code(int code) {
  return code >= STONE && code != OFF;
}

// The highest occupied word of a chain from its info word.
__device__ __forceinline__ int hi_word(int info) {
  DG_ASSERT((info >> OCC) != 0);
  return 31 - __clz(info) - OCC;
}

// The points of word w with a neighbour in the set X (X's dilation), from
// X's words w - 1 (prev), w and w + 1 (next).
__device__ __forceinline__ uint32_t dilate(const Smem& s, uint32_t prev,
                                          uint32_t cur, uint32_t next,
                                          int w) {
  const uint32_t right_of = __funnelshift_l(prev, cur, 1) & s.not_left[w];
  const uint32_t left_of = __funnelshift_r(cur, next, 1) & s.not_right[w];
  return right_of | left_of | __funnelshift_l(prev, cur, 19) |
         __funnelshift_r(cur, next, 19);
}

// Word x of M_c, zero outside c's occupied words lo..hi.
__device__ __forceinline__ uint32_t member_word(const Smem& s, int c, int lo,
                                               int hi, int x) {
  if (x < lo || x > hi) return 0u;
  DG_ASSERT(x >= 0 && x < NW && chain_ok(c) && ((s.info[c] >> (OCC + x)) & 1));
  return s.mem[c][x];
}

// Liberties after the colour `me` plays at p by the set union over the
// words its reach spans: |dilate({p} | M_C) & (E | M_D) & ~{p}|, C and D
// read from p's neighbour codes.
__device__ __forceinline__ int libs_union(const Smem& s, int p, int me) {
  DG_ASSERT(p >= 0 && p < NN && (me == 1 || me == 2));
  const uint2 nb = s.nbr[p];
  const int wp = p >> 5;
  int c[4], lo_k[4], hi_k[4];
  uint32_t own[4], cap[4];    // all ones where the chain takes the role
  int lo = wp, hi = wp;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int code = code_of(nb, k);
    bool first = is_stone_code(code);
#pragma unroll
    for (int i = 0; i < k; ++i) first &= code_of(nb, i) != code;
    c[k] = code & CHAIN;
    const int inf = first ? s.info[c[k]] : 0;
    const bool is_own = first && (code >> COLOUR) == me;
    const bool is_cap = first && !is_own && (inf & LIBS) == 1;
    lo_k[k] = is_own || is_cap ? c[k] >> 5 : NW;
    hi_k[k] = is_own || is_cap ? hi_word(inf) : -1;
    own[k] = is_own ? FULL : 0u;
    cap[k] = is_cap ? FULL : 0u;
    if (is_own) {
      lo = min(lo, lo_k[k]);
      hi = max(hi, hi_k[k]);
    }
  }
  const int w0 = max(lo - 1, 0), w1 = min(hi + 1, NW - 1);
  DG_ASSERT(w0 <= w1 && w1 < NW);
  // X = {p} | M_C and M_D at word x; word w0 - 1 holds none of X
  auto words = [&](int x, uint32_t& xo, uint32_t& xc) {
    xo = x == wp ? 1u << (p & 31) : 0u;
    xc = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = member_word(s, c[k], lo_k[k], hi_k[k], x);
      xo |= m & own[k];
      xc |= m & cap[k];
    }
  };
  uint32_t prev = 0u, cur, cur_c, next, next_c;
  words(w0, cur, cur_c);
  int count = 0;
  for (int w = w0; w <= w1; ++w) {
    words(w + 1, next, next_c);
    uint32_t reach = dilate(s, prev, cur, next, w);
    if (w == wp) reach &= ~(1u << (p & 31));
    count += __popc(reach & (s.empty[w] | cur_c));
    prev = cur;
    cur = next;
    cur_c = next_c;
  }
  return count;
}

// One board a block of WARPS warps.  Thread (warp w, lane l) works on the
// points q = l + 32 j of the slots j = w + WARPS jj.
__global__ void __launch_bounds__(THREADS, 8)
libs_after_kernel(const int32_t* __restrict__ stones,
                  const int32_t* __restrict__ cid,
                  int32_t* __restrict__ out, int batch) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const unsigned lt = (1u << lane) - 1u;   // the lanes below this one
  uint32_t* row = s.task[warp];
  DG_ASSERT(b < batch && tid < THREADS);

  // ---- 0: every global read, then the board in shared memory -----------
  const size_t bp = (size_t)b * NP;
  int vq[SPT], cq[SPT];
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int q = lane + 32 * (warp + WARPS * jj);
    vq[jj] = stones[bp + q];
    cq[jj] = cid[bp + q];
  }
  if (tid < NW) {
    // the bits of word tid in column 0, and in column N - 1
    const int i0 = (N - (32 * tid) % N) % N;
    const int i1 = (i0 + N - 1) % N;
    s.not_left[tid] = ~((1u << i0) | (i0 + N < 32 ? 1u << (i0 + N) : 0u));
    s.not_right[tid] = ~((1u << i1) | (i1 + N < 32 ? 1u << (i1 + N) : 0u));
  }
  int code[SPT];   // the point's code (0 for an empty point or padding)
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int q = lane + 32 * j;
    const int v = vq[jj];
    const bool on = q < NN;
    const bool stone = on && is_stone(v);
    // a stone's chain id is its chain's root, its least point
    DG_ASSERT(!stone || (cq[jj] >= 0 && cq[jj] <= q));
    const int c = cq[jj] >= 0 && cq[jj] <= q ? cq[jj] : q;
    code[jj] = stone ? v << COLOUR | c : 0;
    s.code[q] = (int16_t)code[jj];
    if (stone && c == q) s.info[q] = 0;
    const uint32_t e = __ballot_sync(FULL, on && v == 0);
    if (lane == 0) s.empty[j] = e;
  }
  __syncthreads();

  // ---- 1: neighbour codes; each chain's member words ---------------------
  unsigned grp[SPT];   // the lanes of the slot whose point has the same code
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int q = lane + 32 * j;
    const unsigned on = on_board4(q);
    int n[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      DG_ASSERT(!((on >> k) & 1u) ||
                (q + offset_of(k) >= 0 && q + offset_of(k) < NN));
      n[k] = (on >> k) & 1u ? s.code[q + offset_of(k)] : OFF;
    }
    s.nbr[q] = make_uint2((uint32_t)n[0] | (uint32_t)n[1] << 16,
                          (uint32_t)n[2] | (uint32_t)n[3] << 16);
    const int key = code[jj] >= STONE ? code[jj] : -1;
    grp[jj] = __match_any_sync(FULL, key);
    if (key >= 0 && lane == __ffs(grp[jj]) - 1) {
      const int c = key & CHAIN;
      // the root is a stone of the same colour, its own chain id
      DG_ASSERT(chain_ok(c) && c < NN && s.code[c] == key);
      s.mem[c][j] = grp[jj];
    }
  }
  __syncthreads();

  // ---- 2: each chain's exact liberties ------------------------------------
  // An empty point is a liberty of each distinct neighbouring chain once:
  // it is counted by the chain's stone in its first direction holding the
  // chain.  A slot's stones of one chain sum their counts (three ballots a
  // slot), and the group's leader adds the sum and the word's occupancy bit
  // to the chain's info word: one atomic per chain and word.
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int q = lane + 32 * j;
    const bool stone = code[jj] >= STONE;
    const uint2 nb = s.nbr[q];
    const uint32_t x = (uint32_t)code[jj] * 0x10001u;
    int owned = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (stone && code_of(nb, k) == 0) {
        DG_ASSERT(q + offset_of(k) >= 0 && q + offset_of(k) < NN);
        const uint2 en = s.nbr[q + offset_of(k)];
        // this stone is the empty point's neighbour k ^ 1; an earlier
        // direction holding the chain counts it instead
        const uint32_t lo = __vcmpeq2(en.x, x), hi = __vcmpeq2(en.y, x);
        const unsigned at = (lo & 1u) | (lo >> 15 & 2u) | (hi & 1u) << 2 |
                            (hi >> 13 & 8u);
        owned += (at & ((1u << (k ^ 1)) - 1u)) == 0u;
      }
    }
    // the group's sum of the counts (0..4), by their bits' ballots
    const int sum = __popc(__ballot_sync(FULL, owned & 1) & grp[jj]) +
                    2 * __popc(__ballot_sync(FULL, owned & 2) & grp[jj]) +
                    4 * __popc(__ballot_sync(FULL, owned & 4) & grp[jj]);
    if (stone && lane == __ffs(grp[jj]) - 1) {
      const int c = code[jj] & CHAIN;
      DG_ASSERT(chain_ok(c) && c < NN);
      atomicAdd(&s.info[c], sum + (1 << (OCC + j)));
    }
  }
  __syncthreads();

  // ---- 3: classification, pseudo-legality, point_libs, direct counts ----
  int32_t* o = out + (size_t)b * ROWS * NN;
  unsigned ub[SPT], uw[SPT];    // the lanes whose point takes the union
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int q = lane + 32 * (warp + WARPS * jj);
    const uint2 nb = s.nbr[q];
    const bool empty = q < NN && code[jj] == 0;
    unsigned e4 = 0u, b4 = 0u, w4 = 0u, one4 = 0u, two4 = 0u, first4 = 0u;
    int lib[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cd = code_of(nb, k);
      const bool stone = is_stone_code(cd);
      bool first = stone;
#pragma unroll
      for (int i = 0; i < k; ++i) first &= code_of(nb, i) != cd;
      lib[k] = stone ? s.info[cd & CHAIN] & LIBS : 0;
      e4 |= (cd == 0 ? 1u : 0u) << k;
      b4 |= (stone && (cd >> COLOUR) == 1 ? 1u : 0u) << k;
      w4 |= (stone && (cd >> COLOUR) == 2 ? 1u : 0u) << k;
      one4 |= (lib[k] == 1 ? 1u : 0u) << k;
      two4 |= (lib[k] >= 2 ? 1u : 0u) << k;
      first4 |= (first ? 1u : 0u) << k;
    }
    const int pl = code[jj] >= STONE ? s.info[code[jj] & CHAIN] & LIBS : 0;
    DG_ASSERT(pl <= NN);
    const unsigned at_b = w4 & one4, at_w = b4 & one4;
    const unsigned own_b = b4 & first4, own_w = w4 & first4;
    const bool pseudo_b = empty && (e4 | (b4 & two4) | at_b) != 0u;
    const bool pseudo_w = empty && (e4 | (w4 & two4) | at_w) != 0u;
    const bool union_b = own_b && ((own_b & (own_b - 1u)) || at_b);
    const bool union_w = own_w && ((own_w & (own_w - 1u)) || at_w);
    // no own chain: the empty neighbours and those in captured chains
    int lb = __popc(e4) + __popc(at_b);
    int lw = __popc(e4) + __popc(at_w);
    // one own chain c and no capture: libs(c) less p itself where it is
    // empty, plus the empty neighbours with no neighbour in c
    const bool one_b = own_b && !union_b, one_w = own_w && !union_w;
    if (one_b || one_w) {
      // the chain's code and liberties by selects (an array indexed at run
      // time would live in local memory)
      const int kb = __ffs(own_b) - 1, kw = __ffs(own_w) - 1;
      int cb = 0, cw = 0, lkb = 0, lkw = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cb = kb == k ? code_of(nb, k) : cb;
        lkb = kb == k ? lib[k] : lkb;
        cw = kw == k ? code_of(nb, k) : cw;
        lkw = kw == k ? lib[k] : lkw;
      }
      const uint32_t xb = (uint32_t)cb * 0x10001u, xw = (uint32_t)cw * 0x10001u;
      int ob = 0, ow = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((e4 >> k) & 1u) {
          DG_ASSERT(q + offset_of(k) >= 0 && q + offset_of(k) < NN);
          const uint2 en = s.nbr[q + offset_of(k)];
          ob += (__vcmpeq2(en.x, xb) | __vcmpeq2(en.y, xb)) == 0u;
          ow += (__vcmpeq2(en.x, xw) | __vcmpeq2(en.y, xw)) == 0u;
        }
      }
      const int e = empty ? 1 : 0;
      if (one_b) lb = lkb - e + ob;
      if (one_w) lw = lkw - e + ow;
    }
    ub[jj] = __ballot_sync(FULL, union_b);
    uw[jj] = __ballot_sync(FULL, union_w);
    if (q < NN) {
      // a union point's count is stored by the lane that takes its task
      if (!union_b) o[q] = lb;
      if (!union_w) o[NN + q] = lw;
      o[2 * NN + q] = pl;
      o[3 * NN + q] = pseudo_b ? 1 : 0;
      o[4 * NN + q] = pseudo_w ? 1 : 0;
    }
  }

  // ---- 4: the union tasks, one a lane ------------------------------------
  // Task lists in the order (slot 0, black), (slot 0, white), (slot 1,
  // black), ...; a round deals 32 of them through the warp's task row, and
  // each lane stores its task's count.
  int total = 0;
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) total += __popc(ub[jj]) + __popc(uw[jj]);
  for (int r = 0; 32 * r < total; ++r) {
    int t0 = -32 * r;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
#pragma unroll
      for (int colour = 0; colour < 2; ++colour) {
        const unsigned m = colour ? uw[jj] : ub[jj];
        const int t = t0 + __popc(m & lt);
        if (((m >> lane) & 1u) && t >= 0 && t < 32)
          row[t] = (uint32_t)(lane + 32 * (warp + WARPS * jj)) |
                   (uint32_t)colour << 16;
        t0 += __popc(m);
      }
    }
    __syncwarp();
    if (32 * r + lane < total) {
      const int p = (int)(row[lane] & 0xffffu), colour = (int)(row[lane] >> 16);
      DG_ASSERT(p < NN && colour < 2);
      o[colour * NN + p] = libs_union(s, p, colour + 1);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches one block of WARPS warps per board on `stream`; returns
// cudaGetLastError().
int dg_libs_after(const void* stones, const void* cid, void* out, int batch,
                  void* stream) {
  // eight blocks of ~24 KB an SM need the largest shared-memory carveout
  static bool carveout = false;
  if (!carveout) {
    const cudaError_t err = cudaFuncSetAttribute(
        libs_after_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carveout = true;
  }
  libs_after_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
