// Board code shared by the kernels that play a move on a block-resident
// board: the leaf-step kernel (leaf_step.cu) and the env-step kernel
// (env_step.cu).  One thread block holds one board, one thread per padded
// point (384 threads), and the board lives in shared memory.
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
constexpr int NP = 384;      // padded point axis = threads per block
constexpr int RING = 64;     // super-ko ring entries
constexpr int HIST_W = 128;  // ring row width in the layout
constexpr int NW = NP / 32;  // words per point set (and warps per block)

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

// Play `action` (NN = pass) for the player to move on sm.in, writing
// sm.out, sm.clibs/plibs (sm.in's liberties), sm.hist0/1 and sm.s.
// `meta`, `hash`, `hist` are the board's rows in device memory; `zob` is
// i32[4][384] (black w0, black w1, white w0, white w1).  `Smem` is the
// kernel's shared-memory struct with the members named here.  With
// `kCountLibs` false the caller has already filled sm.clibs/plibs from
// sm.in (and synchronised).  Ends synchronised.
template <class Smem, bool kCountLibs = true>
__device__ void apply_action(Smem& sm, const int32_t* meta,
                             const int32_t* hash, const int32_t* hist,
                             int action, const int32_t* __restrict__ zob) {
  const int q = threadIdx.x;
  if (kCountLibs) chain_liberties(sm.in, sm.clibs, sm.plibs);
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

}  // namespace
