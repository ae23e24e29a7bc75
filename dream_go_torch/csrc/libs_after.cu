// Per-point feature ingredients of the V1 planes for one board per block:
// the exact liberties after playing each point, for black and for white;
// the liberties of the chain holding each point; pseudo-legality for each
// colour.
//
// Replaces the Pallas TPU kernel dream_go_tpu/ops/libs_after.py::_kernel
// (behind liberties_after_both and board_features_raw).  The TPU kernel
// builds [384 x 384] chain-membership matrices and counts through two
// matrix products per colour.  Here one thread block holds one board, one
// thread per padded point (384 threads), and the counting identity of
// ops/libs_after.py:11-15,
//
//   libs_if[p] = #{e != p : (e empty or captured by playing p)
//                           and (e adjacent to p or to an own chain
//                                adjacent to p)},
//
// is evaluated with per-chain 384-bit sets (12 words), as the leaf_step
// kernel's phase B does: A_c = points adjacent to chain c, M_c = members of
// c, E = empty points; reach(p) = N(p) | A_c over the own chains c next to
// p; open(p) = E | M_c over the opponent chains next to p with one liberty;
// libs_if[p] = popcount(reach & open & ~{p}).  Exact integers, no float.
// Unlike leaf_step it counts at every point, not only the pseudo-legal
// ones: the values elsewhere are those of the identity, as in the TPU
// kernel.
//
// What bounds it on an H100: memory traffic is 3 KB in and 7 KB out per
// board, the arithmetic a few thousand integer operations; one wave of
// latency-bound blocks (syncs between the liberty, bit-set and count
// phases) sets the time at the batches the search uses.
//
// Inputs per board (ops/layout.py): stones, cid i32[384].  Output
// i32[5][361]: libs_if_black, libs_if_white, point_libs, pseudo_black,
// pseudo_white.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 19;
constexpr int NN = N * N;    // 361 points
constexpr int NP = 384;      // padded point axis = threads per block
constexpr int NW = NP / 32;  // words per point set
constexpr int ROWS = 5;

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

__global__ void __launch_bounds__(NP)
libs_after_kernel(const int32_t* __restrict__ stones,
                  const int32_t* __restrict__ cid,
                  int32_t* __restrict__ out) {
  __shared__ int32_t st[NP];
  __shared__ int32_t ch[NP];       // chain id, in [0, NN) on every point
  __shared__ int32_t clibs[NP];    // liberties by chain id
  __shared__ int32_t plibs[NP];    // liberties of the chain at each point
  __shared__ uint32_t adj[NP][NW];
  __shared__ uint32_t mem[NP][NW];
  __shared__ uint32_t empty[NW];
  const int b = blockIdx.x;
  const int q = threadIdx.x;
  const bool valid = q < NN;

  const int v0 = valid ? stones[b * NP + q] : 0;
  const int c0 = cid[b * NP + q];
  const bool stone = valid && is_stone(v0);
  st[q] = stone ? v0 : 0;
  ch[q] = stone && c0 >= 0 && c0 < NN ? c0 : (valid ? q : 0);
  clibs[q] = 0;
  for (int w = 0; w < NW; ++w) {
    adj[q][w] = 0u;
    mem[q][w] = 0u;
  }
  if (q < NW) empty[q] = 0u;
  __syncthreads();

  // chain liberties: each empty point adds one to each distinct
  // neighbouring chain; the bit sets in the same pass
  const uint32_t qbit = 1u << (q & 31);
  const int qw = q >> 5;
  int st_k[4], ch_k[4], nb_k[4];
  for (int k = 0; k < 4; ++k) {
    const int n = nbr_of(q, k);
    nb_k[k] = n;
    st_k[k] = n < 0 ? 3 : st[n];
    ch_k[k] = n < 0 ? -1 : ch[n];
  }
  if (valid) {
    if (st[q] == 0) {
      atomicOr(&empty[qw], qbit);
      int ids[4];
      int n = 0;
      for (int k = 0; k < 4; ++k) {
        if (!is_stone(st_k[k])) continue;
        bool dup = false;
        for (int j = 0; j < n; ++j) dup |= ids[j] == ch_k[k];
        if (!dup) ids[n++] = ch_k[k];
      }
      for (int j = 0; j < n; ++j) atomicAdd(&clibs[ids[j]], 1);
    } else {
      atomicOr(&mem[ch[q]][qw], qbit);
    }
    for (int k = 0; k < 4; ++k)
      if (is_stone(st_k[k])) atomicOr(&adj[ch_k[k]][qw], qbit);
  }
  __syncthreads();
  plibs[q] = stone ? clibs[ch[q]] : 0;
  __syncthreads();

  int pl_k[4];
  for (int k = 0; k < 4; ++k)
    pl_k[k] = nb_k[k] < 0 ? 0 : plibs[nb_k[k]];
  if (!valid) return;
  int32_t* o = out + (size_t)b * ROWS * NN + q;
  o[2 * NN] = plibs[q];
  for (int color = 1; color <= 2; ++color) {
    bool has_empty = false, own_ok = false, cap_ok = false;
    uint32_t reach[NW], open[NW];
    for (int w = 0; w < NW; ++w) {
      reach[w] = 0u;
      open[w] = empty[w];
    }
    for (int k = 0; k < 4; ++k) {
      has_empty |= st_k[k] == 0;
      own_ok |= st_k[k] == color && pl_k[k] >= 2;
      cap_ok |= st_k[k] == 3 - color && pl_k[k] == 1;
      const int n = nb_k[k];
      if (n < 0) continue;
      reach[n >> 5] |= 1u << (n & 31);
      if (st_k[k] == color) {
        for (int w = 0; w < NW; ++w) reach[w] |= adj[ch_k[k]][w];
      } else if (st_k[k] == 3 - color && clibs[ch_k[k]] == 1) {
        for (int w = 0; w < NW; ++w) open[w] |= mem[ch_k[k]][w];
      }
    }
    reach[qw] &= ~qbit;
    int count = 0;
    for (int w = 0; w < NW; ++w) count += __popc(reach[w] & open[w]);
    o[(color - 1) * NN] = count;
    o[(2 + color) * NN] =
        (st[q] == 0 && (has_empty || own_ok || cap_ok)) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches one block per board on `stream`; returns cudaGetLastError().
int dg_libs_after(const void* stones, const void* cid, void* out, int batch,
                  void* stream) {
  libs_after_kernel<<<batch, NP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
