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
// Phase A (apply_action) lives in go_board.cuh, shared with the env-step
// kernel (env_step.cu); the layout per board is described there.

#include "go_board.cuh"

namespace {

constexpr int PLANES = 32;

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
