// One environment step per board: legality with positional super-ko, a
// Gumbel-argmax move sample over log(weights) (a pass when no weighted legal
// move exists), then the board update.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/env_step.py::env_step
// (_kernel).  The TPU kernel finds chain liberties with a [384 x 384]
// membership matvec on the matrix unit and reaches neighbours by lane
// rolls.  Here one thread block holds one board, one thread per padded
// point (384 threads), the board in shared memory (go_board.cuh):
//
//   - chain liberties: each empty point adds 1 (shared-memory atomicAdd) to
//     each distinct neighbouring chain id (chain_liberties);
//   - per point: pseudo-legality from the four neighbours, the candidate
//     hash h ^ z[me][q] ^ the aggregates of the distinct captured
//     neighbour chains, its match against the min(placed, 64) valid ring
//     entries, and legality;
//   - per point: the random word (given, or Philox-4x32-10 below), the
//     24-bit uniform u, the Gumbel value and the score; a block argmax
//     with the first index winning ties (warp shuffles, then one warp over
//     the 12 warp partials), as jnp.argmax and torch.argmax break them;
//   - the move through apply_action, K1's phase A, and the rows written
//     out of place (store_rows).
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
// What bounds it on an H100: memory.  A board reads ~7.2 KB of state and
// 1.4 KB of weights (and 1.4 KB of bits when given) and writes ~7.2 KB,
// while its arithmetic is a few thousand integer operations plus up to 64
// ring compares per candidate point.  Every intermediate stays in shared
// memory; weights and bits are read at their stride of 361, unpadded.

#include <math.h>

#include "go_board.cuh"

namespace {

struct Smem {
  Board in;                  // the board before the move
  Board out;                 // the board after the move
  int32_t clibs[NP];         // liberties by chain id
  int32_t plibs[NP];         // liberties of the chain holding each point
  int32_t hist0[RING];       // ring after the move, word 0
  int32_t hist1[RING];       // word 1
  int32_t ring0[RING];       // ring before the move, word 0
  int32_t ring1[RING];       // word 1
  float best_score[NW];      // per-warp argmax partials
  int best_q[NW];
  int move;                  // the sampled action (NN = pass)
  Scalars s;
};

// The new rows of a board after apply_action, written out of place: the
// board, the ring (columns 64..127 copied through), meta and hash (words
// 2..7 and meta[7] copied through).  All threads of the block take part.
__device__ void store_rows(const Smem& sm, int b, const int32_t* meta_b,
                           const int32_t* hash_b, const int32_t* hist_b,
                           int32_t* stones_o, int32_t* cid_o,
                           int32_t* cxp_o, int32_t* hist_o, int32_t* meta_o,
                           int32_t* hash_o) {
  const int q = threadIdx.x;
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
}

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

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (ranks_first(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(NP)
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
                int32_t* __restrict__ move_o) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int q = threadIdx.x;

  const int32_t* meta_b = meta + b * 8;
  const int32_t* hash_b = hashw + b * 8;
  const int32_t* hist_b = hist + b * 2 * HIST_W;
  sm.in.st[q] = stones[b * NP + q];
  sm.in.cid[q] = cid[b * NP + q];
  sm.in.cx0[q] = cxp[b * 2 * NP + q];
  sm.in.cx1[q] = cxp[b * 2 * NP + NP + q];
  if (q < RING) {
    sm.ring0[q] = hist_b[q];
    sm.ring1[q] = hist_b[HIST_W + q];
  }
  __syncthreads();
  chain_liberties(sm.in, sm.clibs, sm.plibs);

  // ---- legality at q ---------------------------------------------------
  const int me = meta_b[0];
  const int opp = 3 - me;
  const int placed = meta_b[1];
  const int done = meta_b[4];
  bool legal = false;
  if (q < NN && sm.in.st[q] == 0 && done == 0) {
    int st_k[4], pl_k[4], cid_k[4];
    int hc0 = hash_b[0] ^ __ldg(&zob[(me == 1 ? 0 : 2) * NP + q]);
    int hc1 = hash_b[1] ^ __ldg(&zob[(me == 1 ? 1 : 3) * NP + q]);
    bool has_empty = false, own_ok = false, cap_any = false;
    for (int k = 0; k < 4; ++k) {
      const int n = nbr_of(q, k);
      st_k[k] = n < 0 ? 3 : sm.in.st[n];
      pl_k[k] = n < 0 ? 0 : sm.plibs[n];
      cid_k[k] = n < 0 ? -1 : sm.in.cid[n];
      has_empty |= st_k[k] == 0;
      own_ok |= st_k[k] == me && pl_k[k] >= 2;
      const bool cap = st_k[k] == opp && pl_k[k] == 1;
      bool dup = false;
      for (int j = 0; j < k; ++j)
        dup |= st_k[j] == opp && pl_k[j] == 1 && cid_k[j] == cid_k[k];
      if (cap) {
        cap_any = true;
        if (!dup) {
          hc0 ^= sm.in.cx0[n];
          hc1 ^= sm.in.cx1[n];
        }
      }
    }
    if (has_empty || own_ok || cap_any) {
      bool in_ring = false;
      const int nvalid = min(placed, RING);
      for (int i = 0; i < nvalid; ++i)
        in_ring |= hc0 == sm.ring0[i] && hc1 == sm.ring1[i];
      legal = !in_ring;
    }
  }

  // ---- sample: Gumbel argmax over the legal weights --------------------
  uint32_t word;
  if (bits != nullptr) {
    word = q < NN ? (uint32_t)bits[(size_t)b * NN + q] : 0u;
  } else {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)meta_b[2], (uint32_t)(q >> 2), 0u, 0u), seed,
        (uint32_t)b);
    const int w = q & 3;
    word = w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
  }
  float u = __fmul_rn((float)(word >> 8), 1.0f / 16777216.0f);
  u = fminf(fmaxf(u, 1e-7f), (float)(1.0 - 1e-7));
  const float g = -logf(-logf(u));
  const float w = q < NN ? fmaxf(weights[(size_t)b * NN + q], 0.0f) : 0.0f;
  float best = (legal && w > 0.0f) ? __fadd_rn(logf(__fadd_rn(w, 1e-30f)), g)
                                   : -INFINITY;
  int best_q = q;
  warp_argmax(best, best_q);
  if ((q & 31) == 0) {
    sm.best_score[q >> 5] = best;
    sm.best_q[q >> 5] = best_q;
  }
  __syncthreads();
  if (q < 32) {
    best = q < NW ? sm.best_score[q] : -INFINITY;
    best_q = q < NW ? sm.best_q[q] : NP;
    warp_argmax(best, best_q);
    if (q == 0) sm.move = (best > -INFINITY && done == 0) ? best_q : NN;
  }
  __syncthreads();

  // ---- apply -------------------------------------------------------------
  // sm.clibs/plibs still hold sm.in's liberties from the legality pass
  apply_action<Smem, false>(sm, meta_b, hash_b, hist_b, sm.move, zob);
  store_rows(sm, b, meta_b, hash_b, hist_b, stones_o, cid_o, cxp_o, hist_o,
             meta_o, hash_o);
  if (q == 0) move_o[b] = sm.s.is_pass ? NN : sm.s.p;
}

}  // namespace

extern "C" {

// Launches one block per board on `stream`; `bits` may be null (Philox
// words from `seed`).  Returns cudaGetLastError().
int dg_env_step(const void* stones, const void* cid, const void* cxp,
                const void* hist, const void* meta, const void* hashw,
                const void* weights, const void* bits, unsigned int seed,
                const void* zob, void* stones_o, void* cid_o, void* cxp_o,
                void* hist_o, void* meta_o, void* hash_o, void* move_o,
                int batch, void* stream) {
  env_step_kernel<<<batch, NP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (const int32_t*)cxp,
      (const int32_t*)hist, (const int32_t*)meta, (const int32_t*)hashw,
      (const float*)weights, (const int32_t*)bits, (uint32_t)seed,
      (const int32_t*)zob, (int32_t*)stones_o, (int32_t*)cid_o,
      (int32_t*)cxp_o, (int32_t*)hist_o, (int32_t*)meta_o, (int32_t*)hash_o,
      (int32_t*)move_o);
  return (int)cudaGetLastError();
}

}  // extern "C"
