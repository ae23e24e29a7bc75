// One MCTS leaf expansion per board: apply the selected action, then
// compute the 32 V1 feature planes and the StandardSearch candidate mask of
// the new position.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/leaf_step.py::leaf_step
// (_make_kernel._kernel, _chain_stats_g).  The TPU kernel builds
// [384 x 384] chain-membership and adjacency matrices and runs them through
// the matrix unit.  Here one thread block holds one board, one thread per
// padded point (384 threads, 12 warps), and the board lives in shared
// memory.
//
// What bounds it on an H100: memory.  A board reads about 7 KB of state and
// writes about 57 KB (the f32 planes dominate), while its arithmetic is a
// few thousand integer operations.  At the search's batches (256, 1024) a
// launch is one or a few waves of blocks, so what a block waits on is what
// the launch takes.  The design therefore keeps every block's chain of
// dependent steps short, and starts its stores early:
//
//   1. every global read is issued at entry, none behind a barrier: the
//      board, the ring, meta, hash, action, komi and the zobrist words of
//      the thread's own point (the move's are then in shared memory);
//   2. the move: the opponent chains next to the move's point are captured
//      iff they have one liberty.  Each empty point sets a bit for each of
//      those (at most four) chains it touches; four warp ballots and one
//      barrier give each chain's count, capped at 2.  Every thread then
//      reads the move's neighbours and the twelve warp counts (broadcast
//      shared loads) and derives the move's scalars itself: no thread works
//      alone while the others wait;
//   3. the new board's chain sets without atomics: M_c (members) is one
//      __match_any_sync per warp on the chain ids, its leader storing the
//      warp's word; A_c (the points next to c) is the dilation of M_c,
//      computed with shifts by the thread at the chain's root (its min
//      point), which also counts libs(c) = |A_c & E| and the span of words
//      A_c occupies.  Only the rows of live chains are touched;
//   4. liberties after a move at q: the four neighbours are classified
//      once, as 4-bit masks (empty, black or white chain, first direction
//      to reach its chain, one liberty, two or more), and each colour's
//      pseudo-legality and count come from a few mask operations.  The
//      count is direct where q touches no own chain (its empty neighbours,
//      plus its neighbours in captured chains) or one own chain and no
//      capture (libs(c) - 1 plus the empty neighbours outside A_c).  Only
//      two or more own chains, or an own chain and a capture, take the set
//      union |(N(q) | A_c...) & (E | M_cap...) & ~{q}| over the words its
//      reach spans (the counting identity of ops/libs_after.py:11-15);
//   5. super-ko: the ring's valid entries set two bits each (hash words 0
//      and 1, low 12 bits) of a 4096-bit filter; a candidate compares with
//      the ring only where both of its bits are set, and then its warp
//      compares it with all 64 entries at once (two a lane, one vote).  The
//      exact compare decides, so the filter changes no result;
//   6. stores in the order their inputs are known: the state rows and the
//      planes of the move's scalars (0, 1, 3, 4, 30, 31) as soon as the move
//      is made; the liberty planes (5-10, 17-22) when the chain counts are;
//      then 11-16, 23-29 and the candidates; plane 2 (any super-ko) last.
//      Meta and hash go out from the last warp's padding lanes, which have
//      no point to work on, without the branches of a per-lane switch.
//
// Five block barriers in all.  A block's time is a chain of dependent
// instructions with few warps to hide it, so the design counts executed
// instructions more than bytes.  Three blocks an SM (at most 56 registers)
// keep the bench's B=1024 to under three waves.  Tensor cores do not pay
// here: this is integer set work of a few thousand operations per board.
//
// Built with -DDG_CHECK (ops/build.py, its own library), a device-side
// assert guards every shared and global index, every chain id used as a
// row (which must be a live chain's root), every ring slot, the filter's
// words and the move's point.
//
// The layout per board is described in go_board.cuh (ops/layout.py).

#include "go_board.cuh"

#ifdef DG_CHECK
#include <cassert>
#define DG_ASSERT(cond) assert(cond)
#else
#define DG_ASSERT(cond) ((void)0)
#endif

namespace {

constexpr int PLANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FILTER_WORDS = 128;            // a 4096-bit ring filter
constexpr int FILTER_MASK = FILTER_WORDS * 32 - 1;

struct Smem {
  int32_t st[NP];              // the board before the move, then after it
  int32_t cid[NP];
  int32_t cx0[NP];
  int32_t cx1[NP];
  int32_t clibs[NP];           // by root: libs | lo word << 16 | hi word << 24
  int32_t hist0[RING];         // ring after the move, word 0
  int32_t hist1[RING];         // word 1
  uint32_t mem[NP][NW];        // M_c (rows of live chains)
  uint32_t adj[NP][NW];        // A_c
  uint32_t empty[NW];          // E
  uint32_t filter[FILTER_WORDS];
  uint32_t capcnt[NW];         // per warp: 4 bytes of capped liberty counts
  int32_t meta[8];
  int32_t hash[8];
  int32_t zp[4];               // zobrist words of the move's point
};

// Word w of the point set {q < NN : q % N != col} (col < 0: all q < NN).
__host__ __device__ constexpr uint32_t points_except_col(int w, int col) {
  uint32_t m = 0u;
  for (int i = 0; i < 32; ++i) {
    const int q = 32 * w + i;
    if (q < NN && q % N != col) m |= 1u << i;
  }
  return m;
}

// A = the points next to a point of M (the dilation of M), word W onwards.
template <int W>
__device__ __forceinline__ void dilate(const uint32_t (&m)[NW],
                                       uint32_t (&a)[NW]) {
  constexpr uint32_t kNotLeft = points_except_col(W, 0);
  constexpr uint32_t kNotRight = points_except_col(W, N - 1);
  constexpr uint32_t kOn = points_except_col(W, -1);
  uint32_t prev = 0u, next = 0u;
  if constexpr (W > 0) prev = m[W - 1];
  if constexpr (W + 1 < NW) next = m[W + 1];
  const uint32_t right_of = ((m[W] << 1) | (prev >> 31)) & kNotLeft;
  const uint32_t left_of = ((m[W] >> 1) | (next << 31)) & kNotRight;
  const uint32_t below = (m[W] << 19) | (prev >> 13);
  const uint32_t above = (m[W] >> 19) | (next << 13);
  a[W] = (right_of | left_of | below | above) & kOn;
  if constexpr (W + 1 < NW) dilate<W + 1>(m, a);
}

__device__ __forceinline__ bool has_bit(uint32_t word, int q) {
  return (word >> (q & 31)) & 1u;
}

// The point q's four neighbours, each direction k one bit of a mask:
// empty, a black or a white chain (a stone whose chain id is valid), the
// first direction to reach its chain, and the chain's liberties (one, two
// or more); with the points, chain ids, liberties and the span of words
// (lo | hi << 8) that each chain's A_c occupies.
struct Nbrs {
  int pt[4], cid[4], libs[4], span[4];
  unsigned empty, black, white, first, one, two;
};

__device__ __forceinline__ int pick(const int (&v)[4], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

// Liberties after a colour plays at the empty point q, by the set union
// over the words [lo, hi] that its reach spans: (N(q) | A_own...) &
// (E | M_cap...) & ~{q}.  `own`, `cap`: the directions of its own chains
// and of the captured ones, each chain once.
__device__ __forceinline__ int libs_union(const Smem& sm, int q,
                                          const Nbrs& nb, unsigned own,
                                          unsigned cap) {
  int lo = NW, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (nb.pt[k] >= 0) {
      lo = min(lo, nb.pt[k] >> 5);
      hi = max(hi, nb.pt[k] >> 5);
    }
    if ((own >> k) & 1u) {
      lo = min(lo, nb.span[k] & 0xff);
      hi = max(hi, nb.span[k] >> 8);
    }
  }
  DG_ASSERT(lo >= 0 && hi < NW && lo <= hi);
  int count = 0;
  for (int w = lo; w <= hi; ++w) {
    uint32_t reach = 0u, open = sm.empty[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      DG_ASSERT(!(((own | cap) >> k) & 1u) || chain_ok(nb.cid[k]));
      if (nb.pt[k] >= 0 && (nb.pt[k] >> 5) == w)
        reach |= 1u << (nb.pt[k] & 31);
      if ((own >> k) & 1u) reach |= sm.adj[nb.cid[k]][w];
      if ((cap >> k) & 1u) open |= sm.mem[nb.cid[k]][w];
    }
    if ((q >> 5) == w) reach &= ~(1u << (q & 31));
    count += __popc(reach & open);
  }
  return count;
}

// Whether a colour (its chains `mine`, the opponent's `theirs`, as
// direction masks) may play at q (pseudo-legal: empty, and an empty
// neighbour, an own neighbour chain with two liberties or an opponent one
// with one), and then the liberties of its chain after the move.
struct After {
  bool pseudo;
  int libs;
};

__device__ __forceinline__ After after_move(const Smem& sm, int q, bool empty,
                                            const Nbrs& nb, unsigned mine,
                                            unsigned theirs) {
  const unsigned atari = theirs & nb.one;
  const unsigned own = mine & nb.first;
  const unsigned cap = atari & nb.first;
  After r;
  r.pseudo = empty && (nb.empty | (mine & nb.two) | atari) != 0u;
  r.libs = 0;  // also where q is not pseudo-legal
  if (!r.pseudo) return r;
  if (own == 0u) {
    // N(q) & (E | M_cap): the empty neighbours and those in captures
    r.libs = __popc(nb.empty) + __popc(atari);
  } else if ((own & (own - 1u)) == 0u && cap == 0u) {
    // libs(c) less q itself, plus the empty neighbours outside A_c
    const int k1 = __ffs(own) - 1;
    const int c = pick(nb.cid, k1);
    DG_ASSERT(chain_ok(c));
    r.libs = pick(nb.libs, k1) - 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (((nb.empty >> k) & 1u) &&
          !has_bit(sm.adj[c][nb.pt[k] >> 5], nb.pt[k]))
        ++r.libs;
  } else {
    r.libs = libs_union(sm, q, nb, own, cap);
  }
  return r;
}

__global__ void __launch_bounds__(NP, 3)
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
                 float* __restrict__ feats_o, uint8_t* __restrict__ cand_o,
                 int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int q = threadIdx.x;
  const int lane = q & 31;
  const int warp = q >> 5;
  const bool valid = q < NN;
  DG_ASSERT(b < batch && q < NP);

  // ---- 0: every global read, issued at once -----------------------------
  const size_t bp = (size_t)b * NP;
  const size_t bh = (size_t)b * 2 * HIST_W;
  const int st0 = stones[bp + q];
  const int cid0 = cid[bp + q];
  const int cx0 = cxp[2 * bp + q];
  const int cx1 = cxp[2 * bp + NP + q];
  const int act = action[b];
  const float km = komi[b];
  int h0w = 0, h1w = 0;
  if (q < HIST_W) {
    h0w = hist[bh + q];
    h1w = hist[bh + HIST_W + q];
  }
  if (q < 8) {
    sm.meta[q] = meta[b * 8 + q];
    sm.hash[q] = hashw[b * 8 + q];
  }
  const int zb0 = __ldg(&zob[q]), zb1 = __ldg(&zob[NP + q]);
  const int zw0 = __ldg(&zob[2 * NP + q]), zw1 = __ldg(&zob[3 * NP + q]);
  int nbr[4];
  for (int k = 0; k < 4; ++k) nbr[k] = nbr_of(q, k);

  DG_ASSERT(act >= 0 && act <= NN);
  const int p = act >= NN ? 0 : act;   // the move's point (0 for a pass)
  sm.st[q] = st0;
  sm.cid[q] = cid0;
  sm.cx0[q] = cx0;
  sm.cx1[q] = cx1;
  sm.clibs[q] = 0;
  if (q < FILTER_WORDS) sm.filter[q] = 0u;
  if (q == p) {
    sm.zp[0] = zb0;
    sm.zp[1] = zb1;
    sm.zp[2] = zw0;
    sm.zp[3] = zw1;
  }
  // a chain after the move keeps its root or is rooted at the move's point
  if (valid && ((is_stone(st0) && cid0 == q) || q == p))
    for (int w = 0; w < NW; ++w) sm.mem[q][w] = 0u;
  __syncthreads();  // B1

  // ---- 1: liberties of the opponent chains next to the move -------------
  const int me = sm.meta[0];
  const int opp = 3 - me;
  const bool frozen = sm.meta[4] > 0;
  const bool is_pass = act >= NN || frozen;
  const bool placing = !is_pass;
  DG_ASSERT(me == 1 || me == 2);
  int pst[4], pcid[4], pcx0[4], pcx1[4], oid[4];
  bool any_oid = false;
  for (int k = 0; k < 4; ++k) {
    const int n = nbr_of(p, k);
    DG_ASSERT(n < NP);
    pst[k] = n < 0 ? 3 : sm.st[n];
    pcid[k] = n < 0 ? -1 : sm.cid[n];
    pcx0[k] = n < 0 ? 0 : sm.cx0[n];
    pcx1[k] = n < 0 ? 0 : sm.cx1[n];
    oid[k] = pst[k] == opp && chain_ok(pcid[k]) ? pcid[k] : -7;
    any_oid |= oid[k] >= 0;
  }
  const bool count_caps = placing && any_oid;  // the same in every thread
  if (count_caps) {
    uint32_t bits = 0u;
    if (valid && st0 == 0) {
      for (int j = 0; j < 4; ++j) {
        const int m = nbr[j];
        if (m < 0 || sm.st[m] != opp) continue;
        const int c = sm.cid[m];
        for (int k = 0; k < 4; ++k)
          if (c == oid[k]) bits |= 1u << k;
      }
    }
    uint32_t packed = 0u;
    for (int k = 0; k < 4; ++k) {
      const int n = __popc(__ballot_sync(FULL, (bits >> k) & 1u));
      packed |= (uint32_t)min(n, 2) << (8 * k);
    }
    if (lane == 0) sm.capcnt[warp] = packed;
  }
  __syncthreads();  // B2

  // ---- 2: the move's scalars (in every thread) and the new board ---------
  uint32_t libs4 = 0u;
  if (count_caps)
    for (int w = 0; w < NW; ++w) libs4 += sm.capcnt[w];
  int cap_id[4], own_id[4];
  int new_id = p;
  for (int k = 0; k < 4; ++k) {
    const bool cap = oid[k] >= 0 && ((libs4 >> (8 * k)) & 0xffu) == 1u;
    cap_id[k] = cap ? oid[k] : -7;
    own_id[k] = pst[k] == me ? pcid[k] : -7;
    if (own_id[k] >= 0) new_id = min(new_id, own_id[k]);
  }
  int capx0 = 0, capx1 = 0;
  int nx0 = me == 1 ? sm.zp[0] : sm.zp[2];
  int nx1 = me == 1 ? sm.zp[1] : sm.zp[3];
  const int zp0 = nx0, zp1 = nx1;
  for (int k = 0; k < 4; ++k) {
    bool dup_c = false, dup_o = false;
    for (int j = 0; j < k; ++j) {
      dup_c |= cap_id[j] == cap_id[k] && cap_id[j] >= 0;
      dup_o |= own_id[j] == own_id[k] && own_id[j] >= 0;
    }
    if (cap_id[k] >= 0 && !dup_c) {
      capx0 ^= pcx0[k];
      capx1 ^= pcx1[k];
    }
    if (own_id[k] >= 0 && !dup_o) {
      nx0 ^= pcx0[k];
      nx1 ^= pcx1[k];
    }
  }
  const int h0 = placing ? (sm.hash[0] ^ zp0 ^ capx0) : sm.hash[0];
  const int h1 = placing ? (sm.hash[1] ^ zp1 ^ capx1) : sm.hash[1];
  const int placed2 = sm.meta[1] + (placing ? 1 : 0);
  const int t2 = frozen ? me : opp;          // to move after the move
  const int o2 = 3 - t2;
  const int last0 = is_pass ? sm.meta[5] : p;
  const int last1 = is_pass ? sm.meta[6] : sm.meta[5];
  const bool done2 = frozen || (is_pass && sm.meta[3] + 1 >= 2);

  bool captured = false, member = false;
  for (int k = 0; k < 4; ++k) {
    captured |= cap_id[k] >= 0 && cid0 == cap_id[k];
    member |= own_id[k] >= 0 && cid0 == own_id[k];
  }
  captured = captured && placing && valid && st0 == opp;
  member = member && placing && st0 == me;
  const bool at_p = placing && q == p;
  const bool joined = member || at_p;
  const int st2 = at_p ? me : (captured ? 0 : st0);
  const int cid2 = joined ? new_id : (captured ? q : cid0);
  const int x0 = joined ? nx0 : (captured ? 0 : cx0);
  const int x1 = joined ? nx1 : (captured ? 0 : cx1);
  sm.st[q] = st2;
  sm.cid[q] = cid2;
  sm.cx0[q] = x0;
  sm.cx1[q] = x1;
  stones_o[bp + q] = st2;
  cid_o[bp + q] = cid2;
  cxp_o[2 * bp + q] = x0;
  cxp_o[2 * bp + NP + q] = x1;

  // M_c: one word per chain and warp, stored by the group's first lane
  const bool stone2 = valid && is_stone(st2);
  const unsigned group = __match_any_sync(FULL, stone2 ? cid2 : -1 - lane);
  if (stone2 && lane == __ffs(group) - 1) {
    DG_ASSERT(chain_ok(cid2));
    sm.mem[cid2][warp] = group;
  }
  const unsigned empties = __ballot_sync(FULL, valid && st2 == 0);
  if (lane == 0) sm.empty[warp] = empties;

  // the ring: the new hash into its slot, the valid entries into the filter
  if (q < RING) {
    const int slot = ((sm.meta[1] % RING) + RING) % RING;
    DG_ASSERT(slot >= 0 && slot < RING);
    const bool hit = placing && q == slot;
    const int r0 = hit ? h0 : h0w, r1 = hit ? h1 : h1w;
    sm.hist0[q] = r0;
    sm.hist1[q] = r1;
    if (q < min(placed2, RING)) {
      DG_ASSERT(((r0 & FILTER_MASK) >> 5) < FILTER_WORDS);
      atomicOr(&sm.filter[(r0 & FILTER_MASK) >> 5], 1u << (r0 & 31));
      atomicOr(&sm.filter[(r1 & FILTER_MASK) >> 5], 1u << (r1 & 31));
    }
    h0w = r0;
    h1w = r1;
  }
  if (q < HIST_W) {
    hist_o[bh + q] = h0w;
    hist_o[bh + HIST_W + q] = h1w;
  }
  // meta and hash, on the last warp's padding lanes (the first warps have
  // the ring), without branches: lanes that diverge there serialise
  if (q >= NP - 8) {
    const int j = q - (NP - 8);
    const int mc = sm.meta[2], pc = sm.meta[3];
    int v = sm.meta[j];
    v = j == 0 ? t2 : v;
    v = j == 1 ? placed2 : v;
    v = j == 2 ? (frozen ? mc : mc + 1) : v;
    v = j == 3 ? (frozen ? pc : (is_pass ? pc + 1 : 0)) : v;
    v = j == 4 ? (done2 ? 1 : 0) : v;
    v = j == 5 ? last0 : v;
    v = j == 6 ? last1 : v;
    meta_o[b * 8 + j] = v;
    hash_o[b * 8 + j] = j == 0 ? h0 : (j == 1 ? h1 : sm.hash[j]);
  }

  // planes of the move's scalars (features.rs:104-148 order)
  float* f = feats_o + (size_t)b * PLANES * NP + q;
  const float kc = fminf(fmaxf(0.5f + 0.5f * km / 7.5f, 0.0f), 1.0f);
  const float on = valid ? 1.0f : 0.0f;
  f[0 * NP] = on * (t2 == 1 ? kc : 0.0f);
  f[1 * NP] = on * (t2 == 1 ? 0.0f : kc);
  f[3 * NP] = (valid && q == last0 && last0 < NN) ? 1.0f : 0.0f;
  f[4 * NP] = (valid && q == last1 && last1 < NN) ? 1.0f : 0.0f;
  f[30 * NP] = 0.0f;
  f[31 * NP] = 0.0f;
  __syncthreads();  // B3

  // ---- 3: A_c and libs(c) at each chain's root ---------------------------
  int nst[4];
  Nbrs nb;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nb.pt[k] = nbr[k];
    nst[k] = nbr[k] < 0 ? 3 : sm.st[nbr[k]];
    nb.cid[k] = nbr[k] < 0 ? -1 : sm.cid[nbr[k]];
  }
  DG_ASSERT(!stone2 || (chain_ok(cid2) && is_stone(sm.st[cid2]) &&
                        sm.cid[cid2] == cid2));
  if (stone2 && cid2 == q) {
    uint32_t m[NW], a[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) m[w] = sm.mem[q][w];
    dilate<0>(m, a);
    int libs = 0, lo = NW, hi = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      sm.adj[q][w] = a[w];
      libs += __popc(a[w] & sm.empty[w]);
      if (a[w] != 0u) {
        lo = min(lo, w);
        hi = w;
      }
    }
    sm.clibs[q] = libs | (lo << 16) | (hi << 24);
  }
  __syncthreads();  // B4

  // ---- 4: liberty planes, liberties after a move, super-ko ---------------
  nb.empty = nb.black = nb.white = nb.first = nb.one = nb.two = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool chain = is_stone(nst[k]) && chain_ok(nb.cid[k]);
    const int v = chain ? sm.clibs[nb.cid[k]] : 0;
    nb.libs[k] = v & 0xffff;
    nb.span[k] = (v >> 16) & 0xffff;
    bool first = chain;
#pragma unroll
    for (int j = 0; j < k; ++j)
      first = first && !(((nb.black | nb.white) >> j & 1u) &&
                         nb.cid[j] == nb.cid[k]);
    nb.empty |= (nst[k] == 0 ? 1u : 0u) << k;
    nb.black |= (chain && nst[k] == 1 ? 1u : 0u) << k;
    nb.white |= (chain && nst[k] == 2 ? 1u : 0u) << k;
    nb.first |= (first ? 1u : 0u) << k;
    nb.one |= (nb.libs[k] == 1 ? 1u : 0u) << k;
    nb.two |= (nb.libs[k] >= 2 ? 1u : 0u) << k;
  }
  const int pl2 = stone2 && chain_ok(cid2) ? sm.clibs[cid2] & 0xffff : 0;
  const int own_libs = st2 == t2 ? pl2 : 0;
  const int opp_libs = st2 == o2 ? pl2 : 0;
  for (int k = 1; k <= 6; ++k) {
    f[(4 + k) * NP] = own_libs >= k ? 1.0f : 0.0f;
    f[(16 + k) * NP] = opp_libs >= k ? 1.0f : 0.0f;
  }

  const bool empty2 = valid && st2 == 0;
  const After black = after_move(sm, q, empty2, nb, nb.black, nb.white);
  const After white = after_move(sm, q, empty2, nb, nb.white, nb.black);
  const bool pseudo_t = t2 == 1 ? black.pseudo : white.pseudo;
  const int lif_t = t2 == 1 ? black.libs : white.libs;  // 0 unless pseudo
  const int lif_o = t2 == 1 ? white.libs : black.libs;

  // super-ko for the player to move: the candidate hash, the filter, then
  // the warp's exact compare of each filter hit against the whole ring
  int hc0 = 0, hc1 = 0;
  bool maybe = false;
  if (pseudo_t) {
    hc0 = h0 ^ (t2 == 1 ? zb0 : zw0);
    hc1 = h1 ^ (t2 == 1 ? zb1 : zw1);
    const unsigned caps =
        (t2 == 1 ? nb.white : nb.black) & nb.one & nb.first;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((caps >> k) & 1u) {
        hc0 ^= sm.cx0[nbr[k]];
        hc1 ^= sm.cx1[nbr[k]];
      }
    }
    const int i0 = hc0 & FILTER_MASK, i1 = hc1 & FILTER_MASK;
    maybe = has_bit(sm.filter[i0 >> 5], i0) &&
            has_bit(sm.filter[i1 >> 5], i1);
  }
  bool in_ring = false;
  unsigned hits = __ballot_sync(FULL, maybe);
  if (hits) {
    const int nvalid = min(placed2, RING);
    const int r0a = sm.hist0[lane], r1a = sm.hist1[lane];
    const int r0b = sm.hist0[lane + 32], r1b = sm.hist1[lane + 32];
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1u;
      DG_ASSERT(src >= 0 && src < 32);
      const int x0c = __shfl_sync(FULL, hc0, src);
      const int x1c = __shfl_sync(FULL, hc1, src);
      const bool eq = (lane < nvalid && r0a == x0c && r1a == x1c) ||
                      (lane + 32 < nvalid && r0b == x0c && r1b == x1c);
      const bool found = __any_sync(FULL, eq);
      if (lane == src) in_ring = found;
    }
  }
  const bool ko = in_ring && pseudo_t;
  for (int k = 1; k <= 6; ++k) {
    f[(10 + k) * NP] = lif_t >= k ? 1.0f : 0.0f;
    f[(22 + k) * NP] = lif_o >= k ? 1.0f : 0.0f;
  }
  f[29 * NP] = ko ? 1.0f : 0.0f;
  if (valid)
    cand_o[(size_t)b * NN + q] = (pseudo_t && !in_ring && !done2) ? 1 : 0;
  const int any_ko = __syncthreads_or(ko);  // B5
  f[2 * NP] = on * (any_ko ? 1.0f : 0.0f);
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
      (float*)feats_o, (uint8_t*)cand_o, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
