// Board constants and point helpers shared by the kernels that read a
// board: the leaf-step kernel (leaf_step.cu), the env-step kernel
// (env_step.cu) and the feature kernel (libs_after.cu).
//
// Layout per board (ops/layout.py): stones, cid i32[384]; cxp i32[2][384];
// hist i32[2][128] (64 ring entries used); meta i32[8] = to_move, placed,
// move_count, pass_count, done, last0, last1, pad; hash i32[8] (words 0,1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 19;
constexpr int NN = N * N;    // 361 points
constexpr int NP = 384;      // padded point axis (K1's threads per block)
constexpr int RING = 64;     // super-ko ring entries
constexpr int HIST_W = 128;  // ring row width in the layout
constexpr int NW = NP / 32;  // words per point set (K1's warps per block)

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

}  // namespace
