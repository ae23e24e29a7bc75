// The batched root-to-leaf PUCT walk of the search: one warp per board,
// each walking its own tree from the root to the leaf it selects.
//
// Replaces no Pallas kernel.  The JAX package runs the walk as a
// jax.lax.while_loop over depth (dream_go_tpu/mcts/search.py:430,
// _select_flat), one XLA loop for the whole batch; the port's plain
// version (ops/select_walk.py::select_walk_plain) is that loop in PyTorch,
// ~40 small launches a level and one host synchronisation a level, run to
// the depth of the deepest board.  This kernel takes the whole walk in one
// launch.
//
// What bounds it on an H100: latency.  A non-root level reads ~1.3 KB (the
// node's visit count and net value, its K = 32 slots of action, child,
// visits and value sum, its bf16 prior row of 362 entries and its 12-word
// candidate bitset), the root ~5.1 KB (the full-width root arrays).  At ~7
// levels a board, 1024 boards read ~15 MB: ~4-5 us at 3.35 TB/s.  But a
// level's reads depend on the node the level before chose, and the walk's
// time is the chain of dependent loads of the deepest board, up to 128
// levels (MAX_BACKUP_DEPTH) of three dependent loads each (the slot row,
// the prior of each slot's action, the chosen slot's child): well under a
// millisecond.  The design therefore keeps every board independent: a warp
// walks its board and stops as soon as its board stops, no board waits for
// the deepest, and four warps a block keep many chains in flight on each
// SM.  The walk's state (node, action, chosen slot, depth) stays in
// registers, uniform across the warp.
//
//   root:   lane l takes the actions l + 32 j (j < 12) of the full-width
//           root arrays, then a warp argmax (first index on ties);
//   level:  lane l takes the slots l + 32 i (any K), records each occupied
//           slot's action in a 12-word bitset in shared memory (the
//           candidates already expanded), a warp argmax over the slots'
//           scores; then the actions l + 32 j whose candidate bit is set
//           and whose action is in no slot, a warp argmax over their
//           priors; the slot-or-new-edge rule picks the action, lane 0
//           writes the level's node and slot to path_n / path_k.
//
// Exactness.  The outputs equal the plain walk's bit for bit.  Each
// `a * b + c` that the plain version rounds once (utils/numerics.fma: a
// float64 product and sum, then float32) is __dmul_rn, __dadd_rn,
// __double2float_rn here, never fmaf; every other product, sum, quotient
// and square root is an _rn intrinsic, so nvcc contracts nothing; the order
// of operations is the plain version's.  Schedules (config.Schedule.at:
// piecewise linear, clamped at the ends) run on the knots the wrapper
// passes.  An argmax takes the first index among equal maxima, NaN above
// every number, as torch.argmax does; non-finite scores are -inf first.
//
// Built with -DDG_CHECK (ops/build.py, its own library), a device-side
// assert guards every node, slot, action and child index.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

#ifdef DG_CHECK
#include <cassert>
#define DG_ASSERT(cond) assert(cond)
#else
#define DG_ASSERT(cond) ((void)0)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int A = 362;          // actions: 361 points + pass
constexpr int NCW = 12;         // candidate bitset words (12 x 32 >= 362)
constexpr int WARPS = 4;        // boards a block
constexpr int NO_INDEX = 0x7fffffff;

// A piecewise-linear schedule: n knots (xp ascending, fp).
struct Schedule {
  const float* xp;
  const float* fp;
  int n;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// a * b + c rounded once to float32, as utils/numerics.fma computes it
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// config.Schedule.at: searchsorted(right=True) clamped to [1, n - 1], the
// interpolation with its multiply-add rounded once, a zero-width segment
// (|dx| <= 2^-46) giving its left value, and the ends clamped.
__device__ float schedule_at(const Schedule s, float x) {
  if (s.n == 1) return s.fp[0];
  int i = 0;
  for (int j = 0; j < s.n; ++j) i += s.xp[j] <= x;
  i = min(max(i, 1), s.n - 1);
  const float df = __fsub_rn(s.fp[i], s.fp[i - 1]);
  const float dx = __fsub_rn(s.xp[i], s.xp[i - 1]);
  const float delta = __fsub_rn(x, s.xp[i - 1]);
  float f = fabsf(dx) <= 0x1p-46f
                ? s.fp[i - 1]
                : fma_once(__fdiv_rn(delta, dx), df, s.fp[i - 1]);
  if (x < s.xp[0]) f = s.fp[0];
  if (x > s.xp[s.n - 1]) f = s.fp[s.n - 1];
  return f;
}

// torch.argmax's order: NaN above every number, then the larger value,
// then the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (a != a) return b == b || ia < ib;
  if (b != b) return false;
  return a > b || (a == b && ia < ib);
}

// The warp's best (value, index), with a payload carried along; every
// lane ends with the same.
__device__ __forceinline__ void warp_best(float& v, int& i, int& pay) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    const int op = __shfl_xor_sync(FULL, pay, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
      pay = op;
    }
  }
}

__device__ __forceinline__ float clamp_min0(float x) {
  return x < 0.0f ? 0.0f : x;  // NaN passes, as torch.clamp
}

struct Tree {
  const int32_t* node_n;       // [B*C]
  const float* value0;         // [B*C]
  const uint16_t* prior;       // bf16 [B*C, A]
  const uint32_t* cand;        // [B*C, NCW]
  const int32_t* slot_action;  // [B*C, K]
  const int32_t* slot_child;
  const int32_t* slot_n;
  const float* slot_w;
  int cap, slots;
};

// The PUCT choice at non-root node g (flat index): the action and the slot
// it takes (-1 for a new edge), warp-uniform.
__device__ void choose_nonroot(const Tree& t, int64_t g, Schedule uct,
                               Schedule fpr, uint32_t* taken, int lane,
                               int& action, int& kc) {
  const float n_tot = __int2float_rn(t.node_n[g]);
  const float fpu = clamp_min0(__fsub_rn(t.value0[g], schedule_at(fpr, n_tot)));
  const float u = __fmul_rn(schedule_at(uct, n_tot),
                            __fsqrt_rn(__fadd_rn(1.0f, n_tot)));
  const uint16_t* row = t.prior + g * A;

  __syncwarp();  // the previous level's readers of `taken` are done
  if (lane < NCW) taken[lane] = 0u;
  __syncwarp();

  float sv = neg_inf();
  int si = NO_INDEX, s_action = -1;
  bool any_occ = false, all_occ = true;
  const int64_t srow = g * t.slots;
  for (int k = lane; k < t.slots; k += 32) {
    const int sa = t.slot_action[srow + k];
    const int sn = t.slot_n[srow + k];
    const float sw = t.slot_w[srow + k];
    const bool occ = sa >= 0;
    DG_ASSERT(sa < A);
    if (occ) atomicOr(&taken[sa >> 5], 1u << (sa & 31));
    const float q = sn > 0 ? __fdiv_rn(sw, __int2float_rn(max(sn, 1))) : fpu;
    const float p = bf16_value(row[max(sa, 0)]);
    float s = fma_once(p, __fdiv_rn(u, __fadd_rn(1.0f, __int2float_rn(sn))), q);
    if (!(occ && isfinite(s))) s = neg_inf();
    any_occ |= occ;
    all_occ &= occ;
    if (beats(s, k, sv, si)) {
      sv = s;
      si = k;
      s_action = sa;
    }
  }
  __syncwarp();  // `taken` is complete
  warp_best(sv, si, s_action);
  any_occ = __any_sync(FULL, any_occ);
  all_occ = __all_sync(FULL, all_occ);

  const uint32_t* cw = t.cand + g * NCW;
  float pv = neg_inf();
  int pi = NO_INDEX, unused = 0;
  bool any_un = false;
#pragma unroll
  for (int j = 0; j < NCW; ++j) {
    const int a = lane + 32 * j;
    if (a < A) {
      const bool un = ((cw[j] & ~taken[j]) >> lane) & 1u;
      const float p = un ? bf16_value(row[a]) : neg_inf();
      any_un |= un;
      if (beats(p, a, pv, pi)) {
        pv = p;
        pi = a;
      }
    }
  }
  warp_best(pv, pi, unused);
  any_un = __any_sync(FULL, any_un);

  const float su = fma_once(pv, u, fpu);
  const bool use_slot = any_occ && (sv >= su || all_occ || !any_un);
  action = use_slot ? s_action : (any_un ? pi : A - 1);
  kc = use_slot ? si : -1;
  DG_ASSERT(kc < t.slots && action >= 0 && action < A);
}

__global__ void __launch_bounds__(32 * WARPS)
select_walk_kernel(Tree t, const int32_t* __restrict__ root_child,
                   const int32_t* __restrict__ root_edge_n,
                   const float* __restrict__ root_edge_w,
                   const float* __restrict__ knots, int n_uct, int n_fpu,
                   int32_t* __restrict__ node_o, int32_t* __restrict__ action_o,
                   int32_t* __restrict__ k_o, int32_t* __restrict__ path_n,
                   int32_t* __restrict__ path_k, int32_t* __restrict__ root_a_o,
                   int batch, int depth) {
  __shared__ uint32_t taken_s[WARPS][NCW];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= batch) return;  // the whole warp
  uint32_t* taken = taken_s[w];
  const Schedule uct{knots, knots + n_uct, n_uct};
  const Schedule fpr{knots + 2 * n_uct, knots + 2 * n_uct + n_fpu, n_fpu};
  const int64_t base = (int64_t)b * t.cap;
  const int64_t rrow = (int64_t)b * A;

  // the root: full-width PUCT over the root arrays
  const float n0 = __int2float_rn(t.node_n[base]);
  const float v00 = t.value0[base];
  const float bonus = __fmul_rn(schedule_at(uct, n0),
                                __fsqrt_rn(__fadd_rn(1.0f, n0)));
  const uint16_t* row0 = t.prior + base * A;
  const uint32_t* c0 = t.cand + base * NCW;
  float rv = neg_inf();
  int ri = NO_INDEX, unused = 0;
  bool any_c = false;
#pragma unroll
  for (int j = 0; j < NCW; ++j) {
    const int a = lane + 32 * j;
    if (a < A) {
      const bool c = (c0[j] >> lane) & 1u;
      const int en = root_edge_n[rrow + a];
      const float q = en > 0
          ? __fdiv_rn(root_edge_w[rrow + a], __int2float_rn(max(en, 1)))
          : v00;
      float s = fma_once(bf16_value(row0[a]),
                         __fdiv_rn(bonus, __fadd_rn(1.0f, __int2float_rn(en))), q);
      if (!(c && isfinite(s))) s = neg_inf();
      any_c |= c;
      if (beats(s, a, rv, ri)) {
        rv = s;
        ri = a;
      }
    }
  }
  warp_best(rv, ri, unused);
  const int root_a = __any_sync(FULL, any_c) ? ri : A - 1;
  DG_ASSERT(root_a >= 0 && root_a < A);

  // the non-root levels, until the walk leaves the tree or reaches `depth`
  int32_t* pn = path_n + (int64_t)b * depth;
  int32_t* pk = path_k + (int64_t)b * depth;
  int node = 0, action = root_a, kc = -1, level = 1;
  int child = root_child[rrow + root_a];
  while (child >= 0) {
    DG_ASSERT(child < t.cap);
    node = child;
    choose_nonroot(t, base + node, uct, fpr, taken, lane, action, kc);
    if (lane == 0) {
      pn[level] = node;
      pk[level] = kc;
    }
    if (++level >= depth || kc < 0) break;
    child = t.slot_child[(base + node) * t.slots + kc];
  }
  if (lane == 0) {
    pn[0] = 0;
    pk[0] = -1;
    node_o[b] = node;
    action_o[b] = action;
    k_o[b] = kc;
    root_a_o[b] = root_a;
  }
  for (int j = level + lane; j < depth; j += 32) {
    pn[j] = -1;
    pk[j] = -1;
  }
}

}  // namespace

extern "C" {

// Launches one warp per board, WARPS boards a block, on `stream`; `knots`
// holds the uct_exp schedule's n_uct visit knots then its n_uct values,
// then fpu_reduce's n_fpu and n_fpu.  Returns cudaGetLastError().
int dg_select_walk(const void* node_n, const void* value0, const void* prior,
                   const void* cand, const void* slot_action,
                   const void* slot_child, const void* slot_n,
                   const void* slot_w, const void* root_child,
                   const void* root_edge_n, const void* root_edge_w,
                   const void* knots, int n_uct, int n_fpu, void* node_o,
                   void* action_o, void* k_o, void* path_n, void* path_k,
                   void* root_a_o, int batch, int cap, int slots, int depth,
                   void* stream) {
  const Tree t{(const int32_t*)node_n,      (const float*)value0,
               (const uint16_t*)prior,      (const uint32_t*)cand,
               (const int32_t*)slot_action, (const int32_t*)slot_child,
               (const int32_t*)slot_n,      (const float*)slot_w,
               cap,                         slots};
  const int blocks = (batch + WARPS - 1) / WARPS;
  select_walk_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      t, (const int32_t*)root_child, (const int32_t*)root_edge_n,
      (const float*)root_edge_w, (const float*)knots, n_uct, n_fpu,
      (int32_t*)node_o, (int32_t*)action_o, (int32_t*)k_o, (int32_t*)path_n,
      (int32_t*)path_k, (int32_t*)root_a_o, batch, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
