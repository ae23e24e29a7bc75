// One environment step per board: legality with positional super-ko, a
// Gumbel-argmax move sample over log(weights) (a pass when no weighted legal
// move exists), then the board update.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/env_step.py::env_step
// (_kernel).  The TPU kernel finds chain liberties with a [384 x 384]
// membership matvec on the matrix unit and reaches neighbours by lane
// rolls.
//
// What bounds it on an H100: memory, if enough boards are in flight.  A
// board reads ~7.2 KB of state and 1.4 KB of weights (and 1.4 KB of words
// when given) and writes ~7.2 KB, while its arithmetic is a few thousand
// integer operations and three logs per weighted legal point.  A board's
// work is a chain of dependent steps (load, liberties, legality, argmax,
// move, store), so the time is latency unless many boards overlap on each
// SM.  The design therefore gives each board a block of its own of four
// warps (WARPS), which split its points three 32-point slots each, work on
// them with warp primitives and meet at five block barriers; no thread
// works alone and no board waits on another.  At 72 registers seven
// boards (28 warps) are resident an SM.  The shape was measured against
// one warp a board (up to 12 an SM at 143 registers, only warp waits) and
// two, three and six warps: four was the fastest or within 2% at every
// batch from 132 to 4096 boards; one warp a board took 1.27x its time at
// B=4096 and 1.9x at B=256, where an SM would hold one or two lone warps.
//
//   0. every global read of the board is started at entry: its stones and
//      chain ids as the thread's points (q = lane + 32 j for its slots j),
//      its aggregates as 16-byte chunks, its ring, meta, hash and
//      weights; the Philox words (below) go to shared memory.  The
//      zobrist table (6 KB, the same for every board) is read through L1
//      where a candidate needs its words;
//   1. a compact board in shared memory (stones int8, chain ids int16, the
//      aggregates int32) and the board's point sets as bitboards: word j
//      of a set is the ballot of slot j (the points 32 j .. 32 j + 31),
//      and a point reads its four neighbours from words j - 1, j, j + 1 by
//      shifts.  Per chain id, its liberties saturated at 2, from two
//      passes of plain stores with no atomics: each stone writes its first
//      empty neighbour as a liberty of its chain (one of the racing writes
//      lands, any will do); then a stone that sees another liberty marks
//      the chain LIBS_2.  Ballots then give the opponent's stones in atari
//      and the player's own stones of chains with two liberties;
//   2. per weighted empty point: pseudo-legal iff a neighbour is empty, an
//      own stone of a chain with two liberties, or an opponent stone in
//      atari (three bitboards); the candidate hash h ^ z[me][q] ^ the
//      aggregates of the distinct captured chains (read only where a
//      capture is); super-ko through K1's ring filter (each valid ring
//      entry sets the bits of its two words' low 12 bits in a 4096-bit
//      filter); a candidate whose two bits are set is compared exactly
//      with all 64 entries by its warp (two a lane, one vote), its hash
//      shuffled from its thread;
//   3. the random words: Philox-4x32-10 once per counter (96 a board, one
//      a thread), four words each; the logs of a thread's points
//      only where one of them can score (a legal point with w > 0); a
//      per-thread, a warp (xor shuffles) and a block argmax, the first
//      index winning ties;
//   4. the move: every thread derives its scalars (captures, merge id,
//      aggregates, hash) from broadcast reads of the move's neighbours;
//      no thread works alone while the others wait;
//   5. the six rows and the move stored out of place, the point rows as
//      16-byte stores, nothing of the input read again from memory.
//
// Random bits.  The TPU kernel seeds its core's generator with
// seed + b * 7919 + move_count * 65537; that stream has no GPU
// counterpart.  Without given bits this kernel draws the word of point q
// from Philox-4x32-10 (Salmon et al., SC'11; the Random123 constants) with
// key (seed, b) and counter (move_count, q / 4, 0, 0), word q % 4: 96
// calls of four words cover the 384 padded points.  ops/env_step.py
// computes the same words in PyTorch.
//
// Exactness.  u = (bits >> 8) * 2^-24, clipped to [1e-7, 1 - 1e-7],
// g = -log(-log(u)), score = log(max(w, 0) + 1e-30) + g where the point is
// legal and w > 0, else -inf: the order of operations of the TPU kernel, in
// IEEE logf (no fast-math intrinsics) with each add and multiply rounded on
// its own (__fadd_rn, __fmul_rn: no contraction into a fused multiply-add).
//
// Built with -DDG_CHECK (ops/build.py, its own library), a device-side
// assert guards every shared and global index, every chain id used as a
// row, every ring slot, the filter's words and the move's point.
//
// The layout per board is described in go_board.cuh (ops/layout.py).

#include <math.h>

#include "go_board.cuh"

#ifdef DG_CHECK
#include <cassert>
#define DG_ASSERT(cond) assert(cond)
#else
#define DG_ASSERT(cond) ((void)0)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOTS = NP / 32;               // 32-point slots (bitboard words)
constexpr int WARPS = 4;                     // warps a board (and a block)
constexpr int THREADS = 32 * WARPS;
constexpr int SPT = SLOTS / WARPS;           // slots a thread
constexpr int FILTER_WORDS = 128;            // a 4096-bit ring filter
constexpr int FILTER_MASK = FILTER_WORDS * 32 - 1;

// A board in shared memory.  Per chain id, `lib` is one of its liberty
// points, or LIBS_0 for none, or LIBS_2 for two or more: its liberties
// saturated at 2.
struct __align__(16) BoardSmem {
  int32_t cx0[NP];
  int32_t cx1[NP];
  int32_t lib[NP];
  uint32_t filter[FILTER_WORDS];
  int16_t cid[NP];
  int8_t st[NP];
};
constexpr int LIBS_0 = -1;
constexpr int LIBS_2 = -2;

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// (score a, index a) ranks before (score b, index b): the larger score,
// and of equal scores the smaller index.
__device__ __forceinline__ bool ranks_first(float sa, int qa, float sb,
                                            int qb) {
  return sa > sb || (sa == sb && qa < qb);
}

__device__ __forceinline__ bool has_bit(const uint32_t* filter, int h) {
  const int i = h & FILTER_MASK;
  DG_ASSERT((i >> 5) < FILTER_WORDS);
  return (filter[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(uint32_t* filter, int h) {
  const int i = h & FILTER_MASK;
  DG_ASSERT((i >> 5) < FILTER_WORDS);
  atomicOr(&filter[i >> 5], 1u << (i & 31));
}

// Liberties of chain c from its `lib` word: 0, 1, or 2 for two or more.
__device__ __forceinline__ int libs_of(const BoardSmem& s, int c) {
  if (!chain_ok(c)) return 0;
  const int v = s.lib[c];
  return v == LIBS_0 ? 0 : (v == LIBS_2 ? 2 : 1);
}

// The point offset of neighbour k (left, right, up, down: nbr_of's order).
__device__ __forceinline__ int offset_of(int k) {
  return (k & 1 ? 1 : -1) * (k & 2 ? N : 1);
}

// v[i] of a thread's slots, for i known only at run time, without indexing
// the array (which would move it to local memory).
__device__ __forceinline__ int pick(const int (&v)[SPT], int i) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < SPT; ++k) r = i == k ? v[k] : r;
  return r;
}

// The point sets of the board as words of 32 points (word j holds the
// points 32 j .. 32 j + 31); the warps of a board share them here.
struct Words {
  uint32_t empty[SLOTS];     // the empty points
  uint32_t atari[SLOTS];     // the opponent's stones of chains with one liberty
  uint32_t safe[SLOTS];      // own stones of chains with two liberties or more
};

// Bit k: the neighbour k of the point q = lane + 32 j is in the point set
// S (words of 32 points), read from words j - 1, j and j + 1; the caller
// masks the neighbours that are off the board.
__device__ __forceinline__ unsigned nbr_bits(const uint32_t* S, int j,
                                             int lane) {
  const uint32_t a = j > 0 ? S[j - 1] : 0u, m = S[j];
  const uint32_t c = j + 1 < SLOTS ? S[j + 1] : 0u;
  const uint64_t lo = ((uint64_t)m << 32) | a;
  const uint64_t hi = ((uint64_t)c << 32) | m;
  return (unsigned)((lo >> (31 + lane)) & 1u) |
         (unsigned)((hi >> (1 + lane)) & 1u) << 1 |
         (unsigned)((lo >> (13 + lane)) & 1u) << 2 |
         (unsigned)((hi >> (19 + lane)) & 1u) << 3;
}

// One board a block of WARPS warps.  Thread (warp w, lane l) works on the
// points q = l + 32 j of the slots j = w + WARPS jj.
__global__ void __launch_bounds__(THREADS, 4)
env_step_kernel(const int32_t* __restrict__ stones,
                const int32_t* __restrict__ cid,
                const int32_t* __restrict__ cxp,
                const int32_t* __restrict__ hist,
                const int32_t* __restrict__ meta,
                const int32_t* __restrict__ hashw,
                const float* __restrict__ weights,
                const int32_t* __restrict__ bits, uint32_t seed,
                const int32_t* __restrict__ zob,
                int32_t* __restrict__ stones_o, int32_t* __restrict__ cid_o,
                int32_t* __restrict__ cxp_o, int32_t* __restrict__ hist_o,
                int32_t* __restrict__ meta_o, int32_t* __restrict__ hash_o,
                int32_t* __restrict__ move_o, int batch) {
  __shared__ BoardSmem s;
  __shared__ Words words;
  __shared__ uint32_t rnd[NP];    // the Philox words of the points
  __shared__ float part_s[WARPS]; // the warps' argmax partials
  __shared__ int part_q[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const bool chunk = tid < NP / 4;  // the thread's 4-point chunk: tid
  DG_ASSERT(b < batch && tid < THREADS);

  // ---- 0: every global read, started at entry ----------------------------
  const size_t bp = (size_t)b * NP;
  const size_t bh = (size_t)b * 2 * HIST_W;
  int stq[SPT], cidq[SPT];   // the thread's points
  float wt[SPT];
  int4 x04, x14;
  int ring[8];    // hist[lane + 32 r]: word 0 at r < 4, word 1 at r >= 4
  int mv = 0, hv = 0;
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int q = lane + 32 * (warp + WARPS * jj);
    stq[jj] = stones[bp + q];
    cidq[jj] = cid[bp + q];
    wt[jj] = q < NN ? weights[(size_t)b * NN + q] : 0.0f;
  }
  if (chunk) {
    x04 = reinterpret_cast<const int4*>(cxp + 2 * bp)[tid];
    x14 = reinterpret_cast<const int4*>(cxp + 2 * bp + NP)[tid];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) ring[r] = hist[bh + lane + 32 * r];
  if (lane < 8) {
    mv = meta[(size_t)b * 8 + lane];
    hv = hashw[(size_t)b * 8 + lane];
  }

#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int q = lane + 32 * (warp + WARPS * jj);
    // the int8 and int16 rows hold every value of a board from the engine
    DG_ASSERT(stq[jj] >= -128 && stq[jj] <= 127 && cidq[jj] >= -32768 &&
              cidq[jj] <= 32767);
    s.st[q] = (int8_t)stq[jj];
    s.cid[q] = (int16_t)cidq[jj];
    if (q >= NN) stq[jj] = 0;   // the padding is no point of the board
  }
  if (chunk) {
    reinterpret_cast<int4*>(s.cx0)[tid] = x04;
    reinterpret_cast<int4*>(s.cx1)[tid] = x14;
    reinterpret_cast<int4*>(s.lib)[tid] =
        make_int4(LIBS_0, LIBS_0, LIBS_0, LIBS_0);
  }
  if (tid < 32)
    reinterpret_cast<uint4*>(s.filter)[tid] = make_uint4(0u, 0u, 0u, 0u);
  const int me = __shfl_sync(FULL, mv, 0);
  const int opp = 3 - me;
  const int placed = __shfl_sync(FULL, mv, 1);
  const int mc = __shfl_sync(FULL, mv, 2);
  const int pc = __shfl_sync(FULL, mv, 3);
  const int done = __shfl_sync(FULL, mv, 4);
  const int m5 = __shfl_sync(FULL, mv, 5);
  const int m6 = __shfl_sync(FULL, mv, 6);
  const int h0 = __shfl_sync(FULL, hv, 0);
  const int h1 = __shfl_sync(FULL, hv, 1);
  const int nvalid = min(placed, RING);
  // the random words: Philox once per counter (q / 4), four points each
  if (bits == nullptr && chunk)
    reinterpret_cast<uint4*>(rnd)[tid] = philox4x32_10(
        make_uint4((uint32_t)mc, (uint32_t)tid, 0u, 0u), seed, (uint32_t)b);

  // ---- 1: bitboards; each chain's liberties, saturated at 2 -------------
  // Word j of a point set holds bit `lane` for the point q = lane + 32 j,
  // so a ballot per slot makes it and a point reads its neighbours from
  // words j - 1, j, j + 1 with shifts (nbr_bits).
  if (warp == 0) {   // the warp that zeroed the filter
    __syncwarp();
    if (lane < nvalid) {
      set_bit(s.filter, ring[0]);
      set_bit(s.filter, ring[4]);
    }
    if (lane + 32 < nvalid) {
      set_bit(s.filter, ring[1]);
      set_bit(s.filter, ring[5]);
    }
  }
  unsigned valid4[SPT];     // bit k: neighbour k is on the board
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int q = lane + 32 * j;
    const int x = q % N;
    valid4[jj] = q < NN ? ((x > 0 ? 1u : 0u) | (x < N - 1 ? 2u : 0u) |
                           (q >= N ? 4u : 0u) | (q + N < NN ? 8u : 0u))
                        : 0u;
    const uint32_t e = __ballot_sync(FULL, q < NN && stq[jj] == 0);
    if (lane == 0) words.empty[j] = e;
  }
  __syncthreads();
  // Each stone with an empty neighbour writes its first one as a liberty
  // of its chain (one of the racing writes lands, any will do); then a
  // stone that sees another liberty (two of its own, or one that is not
  // the landed one) marks the chain LIBS_2.  Plain stores, no atomics.
  unsigned libs4[SPT];      // bit k: neighbour k is empty (stones only)
  int root[SPT];            // the stone's chain id (-1: no stone)
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const bool stone = is_stone(stq[jj]);
    const int c = cidq[jj];
    // a stone's chain id is its chain's root, a stone of its colour
    DG_ASSERT(!stone ||
              (chain_ok(c) && s.cid[c] == c && s.st[c] == stq[jj]));
    root[jj] = stone && chain_ok(c) ? c : -1;
    libs4[jj] =
        root[jj] >= 0 ? nbr_bits(words.empty, j, lane) & valid4[jj] : 0u;
  }
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj)
    if (libs4[jj])
      s.lib[root[jj]] =
          lane + 32 * (warp + WARPS * jj) + offset_of(__ffs(libs4[jj]) - 1);
  __syncthreads();
  unsigned two = 0u;        // bit jj: this stone sees a second liberty
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int q = lane + 32 * (warp + WARPS * jj);
    const int v = s.lib[root[jj] >= 0 ? root[jj] : 0];
    const bool more =
        libs4[jj] && ((libs4[jj] & (libs4[jj] - 1u)) ||
                      v != q + offset_of(__ffs(libs4[jj]) - 1));
    two |= (more ? 1u : 0u) << jj;
  }
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj)
    if ((two >> jj) & 1u) s.lib[root[jj]] = LIBS_2;
  __syncthreads();
  // the stones in atari of the opponent, and the player's own stones of
  // chains with two liberties or more
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int v = s.lib[root[jj] >= 0 ? root[jj] : 0];
    const uint32_t a =
        __ballot_sync(FULL, root[jj] >= 0 && stq[jj] == opp && v >= 0);
    const uint32_t f =
        __ballot_sync(FULL, root[jj] >= 0 && stq[jj] == me && v == LIBS_2);
    if (lane == 0) {
      words.atari[j] = a;
      words.safe[j] = f;
    }
  }
  __syncthreads();

  // ---- 2: pseudo-legality and the candidate hashes, then super-ko --------
  const int32_t* zrow = zob + (me == 1 ? 0 : 2) * NP;
  float w[SPT];
  int hc0[SPT], hc1[SPT];
  unsigned pseudo_m = 0u, capt_m = 0u;
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = warp + WARPS * jj;
    const int q = lane + 32 * j;
    const int qs = q < NN ? q : 0;
    w[jj] = fmaxf(wt[jj], 0.0f);
    hc0[jj] = h0 ^ __ldg(&zrow[qs]);
    hc1[jj] = h1 ^ __ldg(&zrow[NP + qs]);
    const unsigned near_atari = nbr_bits(words.atari, j, lane) & valid4[jj];
    const unsigned open = ((nbr_bits(words.empty, j, lane) |
                            nbr_bits(words.safe, j, lane)) &
                           valid4[jj]) |
                          near_atari;
    // only a weighted empty point of a live game can win the argmax
    const bool pseudo = q < NN && stq[jj] == 0 && done == 0 &&
                        w[jj] > 0.0f && open != 0u;
    pseudo_m |= (pseudo ? 1u : 0u) << jj;
    capt_m |= (pseudo && near_atari ? 1u : 0u) << jj;
  }
  // the aggregates of the captured chains, each chain once (rare)
  if (capt_m) {
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      if ((capt_m >> jj) & 1u) {
        const int j = warp + WARPS * jj;
        const int q = lane + 32 * j;
        const unsigned cap = nbr_bits(words.atari, j, lane) & valid4[jj];
        int c_k[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = q + offset_of(k);
          const bool on = (cap >> k) & 1u;
          DG_ASSERT(!on || (n >= 0 && n < NN));
          c_k[k] = on ? s.cid[n] : -1;
          bool dup = false;
#pragma unroll
          for (int i = 0; i < k; ++i) dup |= c_k[i] == c_k[k];
          if (on && !dup) {
            hc0[jj] ^= s.cx0[n];
            hc1[jj] ^= s.cx1[n];
          }
        }
      }
    }
  }
  unsigned maybe_m = 0u;
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const bool maybe =
        has_bit(s.filter, hc0[jj]) & has_bit(s.filter, hc1[jj]);
    maybe_m |= (maybe ? 1u : 0u) << jj;
  }
  maybe_m &= pseudo_m;
  // each filter hit compared with the whole ring by its warp (two entries
  // a lane)
  unsigned ring_m = 0u;
  unsigned who = __ballot_sync(FULL, maybe_m != 0u);
  while (who) {
    const int src = __ffs(who) - 1;
    who &= who - 1u;
    unsigned m = __shfl_sync(FULL, maybe_m, src);
    while (m) {
      const int jj = __ffs(m) - 1;
      m &= m - 1u;
      // the hit's hash, from its thread (a select: jj is known at run time)
      const int x0 = __shfl_sync(FULL, pick(hc0, jj), src);
      const int x1 = __shfl_sync(FULL, pick(hc1, jj), src);
      const bool eq = (lane < nvalid && ring[0] == x0 && ring[4] == x1) ||
                      (lane + 32 < nvalid && ring[1] == x0 && ring[5] == x1);
      const bool found = __any_sync(FULL, eq);
      if (lane == src && found) ring_m |= 1u << jj;
    }
  }
  const unsigned legal_m = pseudo_m & ~ring_m;

  // ---- 3: the scores and the argmax --------------------------------------
  // the logs of the thread's points, where one of them is legal (a warp
  // whose points are all illegal or weightless takes none)
  float best = -INFINITY;
  int best_q = lane + 32 * warp;
  if (legal_m) {
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int q = lane + 32 * (warp + WARPS * jj);
      const uint32_t word = bits != nullptr
                                ? (uint32_t)bits[(size_t)b * NN + (q < NN ? q : 0)]
                                : rnd[q];
      float u = __fmul_rn((float)(word >> 8), 1.0f / 16777216.0f);
      u = fminf(fmaxf(u, 1e-7f), (float)(1.0 - 1e-7));
      const float g = -logf(-logf(u));
      const float score = __fadd_rn(logf(__fadd_rn(w[jj], 1e-30f)), g);
      // q rises with jj: the first index keeps ties
      if (((legal_m >> jj) & 1u) && score > best) {
        best = score;
        best_q = q;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(FULL, best, off);
    const int oq = __shfl_xor_sync(FULL, best_q, off);
    if (ranks_first(os, oq, best, best_q)) {
      best = os;
      best_q = oq;
    }
  }
  if (lane == 0) {
    part_s[warp] = best;
    part_q[warp] = best_q;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    if (ranks_first(part_s[v], part_q[v], best, best_q)) {
      best = part_s[v];
      best_q = part_q[v];
    }
  }

  // ---- 4: the move's scalars, in every lane ------------------------------
  const int action = (best > -INFINITY && done == 0) ? best_q : NN;
  const bool frozen = done > 0;
  const bool is_pass = action >= NN || frozen;
  const bool placing = !is_pass;
  const int p = action >= NN ? 0 : action;
  DG_ASSERT(p >= 0 && p < NN);
  int cap_id[4], own_id[4], x0_k[4], x1_k[4];
  int new_id = p;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = nbr_of(p, k);
    DG_ASSERT(n < NP);
    const int st = n < 0 ? 3 : s.st[n];
    const int c = n < 0 ? -1 : s.cid[n];
    const int lb = is_stone(st) ? libs_of(s, c) : 0;
    x0_k[k] = n < 0 ? 0 : s.cx0[n];
    x1_k[k] = n < 0 ? 0 : s.cx1[n];
    cap_id[k] = st == opp && lb == 1 ? c : -7;
    own_id[k] = st == me ? c : -7;
    if (own_id[k] >= 0) new_id = min(new_id, own_id[k]);
  }
  const int zp0 = __ldg(&zrow[p]), zp1 = __ldg(&zrow[NP + p]);
  int capx0 = 0, capx1 = 0, nx0 = zp0, nx1 = zp1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool dup_c = false, dup_o = false;
#pragma unroll
    for (int i = 0; i < k; ++i) {
      dup_c |= cap_id[i] == cap_id[k] && cap_id[i] >= 0;
      dup_o |= own_id[i] == own_id[k] && own_id[i] >= 0;
    }
    if (cap_id[k] >= 0 && !dup_c) {
      capx0 ^= x0_k[k];
      capx1 ^= x1_k[k];
    }
    if (own_id[k] >= 0 && !dup_o) {
      nx0 ^= x0_k[k];
      nx1 ^= x1_k[k];
    }
  }
  const int g0 = placing ? (h0 ^ zp0 ^ capx0) : h0;
  const int g1 = placing ? (h1 ^ zp1 ^ capx1) : h1;

  // ---- 5: the new rows, out of place -------------------------------------
  if (chunk) {
    const int c = tid;
    const char4 sv = reinterpret_cast<const char4*>(s.st)[c];
    const short4 cv = reinterpret_cast<const short4*>(s.cid)[c];
    const int4 xa = reinterpret_cast<const int4*>(s.cx0)[c];
    const int4 xb = reinterpret_cast<const int4*>(s.cx1)[c];
    const int st_e[4] = {sv.x, sv.y, sv.z, sv.w};
    const int c_e[4] = {cv.x, cv.y, cv.z, cv.w};
    const int xa_e[4] = {xa.x, xa.y, xa.z, xa.w};
    const int xb_e[4] = {xb.x, xb.y, xb.z, xb.w};
    int so[4], co[4], ao[4], bo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 4 * c + e;
      bool captured = false, member = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        captured |= cap_id[k] >= 0 && c_e[e] == cap_id[k];
        member |= own_id[k] >= 0 && c_e[e] == own_id[k];
      }
      captured = captured && placing && q < NN && st_e[e] == opp;
      member = member && placing && st_e[e] == me;
      const bool at_p = placing && q == p;
      const bool joined = member || at_p;
      so[e] = at_p ? me : (captured ? 0 : st_e[e]);
      co[e] = joined ? new_id : (captured ? q : c_e[e]);
      ao[e] = joined ? nx0 : (captured ? 0 : xa_e[e]);
      bo[e] = joined ? nx1 : (captured ? 0 : xb_e[e]);
    }
    reinterpret_cast<int4*>(stones_o + bp)[c] =
        make_int4(so[0], so[1], so[2], so[3]);
    reinterpret_cast<int4*>(cid_o + bp)[c] =
        make_int4(co[0], co[1], co[2], co[3]);
    reinterpret_cast<int4*>(cxp_o + 2 * bp)[c] =
        make_int4(ao[0], ao[1], ao[2], ao[3]);
    reinterpret_cast<int4*>(cxp_o + 2 * bp + NP)[c] =
        make_int4(bo[0], bo[1], bo[2], bo[3]);
  }
  // the ring: the new hash into its slot; columns 64..127 copied through
  const int slot = ((placed % RING) + RING) % RING;
  DG_ASSERT(slot >= 0 && slot < RING);
  const bool hit_a = placing && lane == slot;
  const bool hit_b = placing && lane + 32 == slot;
  ring[0] = hit_a ? g0 : ring[0];
  ring[4] = hit_a ? g1 : ring[4];
  ring[1] = hit_b ? g0 : ring[1];
  ring[5] = hit_b ? g1 : ring[5];
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) hist_o[bh + lane + 32 * r] = ring[r];
  }
  if (warp == 0 && lane < 8) {
    int v = mv;  // meta[7] copied through
    v = lane == 0 ? (frozen ? me : opp) : v;
    v = lane == 1 ? placed + (placing ? 1 : 0) : v;
    v = lane == 2 ? (frozen ? mc : mc + 1) : v;
    v = lane == 3 ? (frozen ? pc : (is_pass ? pc + 1 : 0)) : v;
    v = lane == 4 ? ((frozen || (is_pass && pc + 1 >= 2)) ? 1 : 0) : v;
    v = lane == 5 ? (is_pass ? m5 : p) : v;
    v = lane == 6 ? (is_pass ? m6 : m5) : v;
    meta_o[(size_t)b * 8 + lane] = v;
    hash_o[(size_t)b * 8 + lane] = lane == 0 ? g0 : (lane == 1 ? g1 : hv);
  }
  if (tid == 0) move_o[b] = is_pass ? NN : p;
}

}  // namespace

extern "C" {

// Launches one block of WARPS warps per board on `stream`; `bits` may be
// null (Philox words from `seed`).  Returns cudaGetLastError().
int dg_env_step(const void* stones, const void* cid, const void* cxp,
                const void* hist, const void* meta, const void* hashw,
                const void* weights, const void* bits, unsigned int seed,
                const void* zob, void* stones_o, void* cid_o, void* cxp_o,
                void* hist_o, void* meta_o, void* hash_o, void* move_o,
                int batch, void* stream) {
  env_step_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (const int32_t*)cxp,
      (const int32_t*)hist, (const int32_t*)meta, (const int32_t*)hashw,
      (const float*)weights, (const int32_t*)bits, (uint32_t)seed,
      (const int32_t*)zob, (int32_t*)stones_o, (int32_t*)cid_o,
      (int32_t*)cxp_o, (int32_t*)hist_o, (int32_t*)meta_o, (int32_t*)hash_o,
      (int32_t*)move_o, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
