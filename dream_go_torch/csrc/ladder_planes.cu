// Ladder feature planes 30 (capture) and 31 (escape) for the player to move,
// with the reference's exact branching ladder reading (ladder.rs:53-178).
//
// Replaces the Pallas TPU kernel
// dream_go_tpu/ops/ladder_kernel.py::ladder_planes_kernel (_kernel,
// _chase_group, _place, _plibs_full, _valid_at).  The TPU kernel runs one
// board per grid step, eight chase lanes as the sublanes of [8, 384] rows,
// and keeps per-point chain liberties up to date as a chase goes (a
// placement recounts the merged chain and its neighbours, a capture the
// whole board).  Here the candidates of a board are independent chases.
//
// What bounds it on an H100: latency, not bytes or operations.  A board
// reads 3 KB and writes 722 bytes, and a rung is a few hundred integer
// operations; but the rungs of a chase are a chain of dependent warp
// operations, so a launch lasts as long as the longest chain of rungs one
// warp walks.  The design makes that chain short:
//
//   - one thread block per board, eight warps; every capture start and
//     every escape start of the board is one job, and a warp takes the next
//     job from a shared-memory counter when it finishes one, so a warp that
//     draws a long chase does not also run the next long one;
//   - a warp holds its chase's board as bitboards in registers: lane r
//     (0-18) holds row r of the attacker's stones A, the defender's stones D
//     and the chased chain K as 19-bit masks (lanes 19-31 hold zeros).
//     Left and right neighbours are shifts within a lane, up and down are
//     __shfl_up_sync/__shfl_down_sync: there is no loop over points and no
//     per-point % or switch in a chase;
//   - there is no liberty table to keep up: a chain is the fixpoint of
//     m = dilate(m) & own, which a vote ends, and its liberties are
//     __reduce_add_sync(popc(dilate(m) & empty)).  A placement looks only at
//     the chains next to its point; a capture clears the captured chain's
//     bits and needs no recount;
//   - the chased chain K only grows, so the extension regrows it from last
//     rung's mask plus the new stone (one or two fill steps), never from one
//     stone;
//   - every other chain a rung asks about (an attacker chain next to the
//     chased chain, a chain next to a point whose legality is read) matters
//     only when it has fewer than two liberties, and then each of its stones
//     has at most one empty neighbour: its fill runs inside such stones and
//     stops at the first stone outside them, a step or two in a ladder;
//   - a branch save is three words a lane (A, D, K) in the warp's stack in
//     shared memory (8 slots of 384 bytes); a restore is three loads.
//
// The board scan (liberties by chain id with shared-memory atomics, then the
// candidate points, once per board) is block-wide, as in the first version.
// A chase takes chains as the connected components of each colour; for
// every state the engine makes, those are the layout's chain ids.
//
// The direction order is go/topology.NBR's (up, left, right, down): the
// chase takes the FIRST qualifying extension and branch in this order.  The
// bounds are fail-safe as in the reference: a chase stops after `budget`
// rungs and a full stack drops the branch, both losing the capture.
//
// Built with -DDG_CHECK (ops/build.py, its own library), a device-side
// assert guards every shared and global index, every point a chase reads or
// plays, every fill's length and the stack pointer.
//
// Inputs per board (ops/layout.py): stones, cid i32[384]; to_move i32.
// Outputs: capture, escape bool[361].

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef DG_CHECK
#include <cassert>
#define DG_ASSERT(cond) assert(cond)
#else
#define DG_ASSERT(cond) ((void)0)
#endif

namespace {

constexpr int N = 19;
constexpr int NN = N * N;    // 361 points
constexpr int NP = 384;      // padded point axis of the layout
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STACK_CAP = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ROW = (1u << N) - 1u;

// One branch-stack slot of a warp: lane r saves row r of A, D and K.
struct Slot {
  uint32_t a[32], d[32], k[32];
};

struct Smem {
  int32_t libs0[NP];             // the board's liberties by chain id
  int16_t cid0[NP];
  int16_t cap_list[NP];
  int16_t esc_list[NP];
  int8_t st0[NP];
  uint8_t cap_flag[NP];          // candidates, then results
  uint8_t esc_flag[NP];
  uint32_t rows[2][32];          // black's and white's stones, row r at [r]
  int ncap, nesc, next_job;
  Slot stack[WARPS][STACK_CAP];
  int16_t satk[WARPS][STACK_CAP];
};
static_assert(sizeof(Smem) <= 48 * 1024, "no opt-in for more shared memory");

// ---------------------------------------------------------------------------
// the board scan

// Neighbour of q in direction k (up, left, right, down), -1 off the board.
__device__ __forceinline__ int nbr(int q, int k) {
  const int x = q % N;
  switch (k) {
    case 0: return q >= N ? q - N : -1;
    case 1: return x > 0 ? q - 1 : -1;
    case 2: return x < N - 1 ? q + 1 : -1;
    default: return q + N < NN ? q + N : -1;
  }
}

__device__ __forceinline__ bool is_stone(int v) { return v == 1 || v == 2; }

// Each empty point adds one to each distinct neighbouring chain.  The
// caller zeroes `libs` and synchronises.
__device__ void add_liberties(const int8_t* st, const int16_t* cid,
                              int32_t* libs, int first, int stride) {
  for (int q = first; q < NN; q += stride) {
    if (st[q] != 0) continue;
    int ids[4];
    int n = 0;
    for (int k = 0; k < 4; ++k) {
      const int y = nbr(q, k);
      if (y < 0 || !is_stone(st[y])) continue;
      const int c = cid[y];
      bool dup = false;
      for (int j = 0; j < n; ++j) dup |= ids[j] == c;
      if (!dup) ids[n++] = c;
    }
    for (int j = 0; j < n; ++j) {
      DG_ASSERT(ids[j] >= 0 && ids[j] < NP);
      atomicAdd(&libs[ids[j]], 1);
    }
  }
}

// ---------------------------------------------------------------------------
// a warp's bitboards: lane r holds row r of each mask; `vm` is the lane's
// row of the board (ROW on lanes 0-18, 0 on the others)

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

struct Pt {
  int p, r, c;   // point, row, column
};

__device__ __forceinline__ Pt pt(int p) {
  DG_ASSERT(p >= 0 && p < NN);
  const int r = p / N;
  return {p, r, p - r * N};
}

// This lane's row of the one-point mask {q}.
__device__ __forceinline__ unsigned bit(Pt q) {
  return lane_id() == q.r ? 1u << q.c : 0u;
}

#ifdef DG_CHECK
// Whether q is in the mask m (the same answer on every lane).
__device__ __forceinline__ bool has(unsigned m, Pt q) {
  return (__shfl_sync(FULL, m, q.r) >> q.c) & 1u;
}
#endif

__device__ __forceinline__ bool any(unsigned m) {
  return __any_sync(FULL, m != 0u);
}

__device__ __forceinline__ int count(unsigned m) {
  return (int)__reduce_add_sync(FULL, (unsigned)__popc(m));
}

// The lowest point of m; NN when m is empty.
__device__ __forceinline__ int first_point(unsigned m) {
  const unsigned v = m ? lane_id() * N + __ffs(m) - 1 : (unsigned)NN;
  return (int)__reduce_min_sync(FULL, v);
}

// m and its four neighbours, on the board.  Row 0's "row above" is its
// own, which adds nothing; rows past 18 hold zeros.
__device__ __forceinline__ unsigned dilate(unsigned m, unsigned vm) {
  const unsigned up = __shfl_up_sync(FULL, m, 1);
  const unsigned dn = __shfl_down_sync(FULL, m, 1);
  return (m | (m << 1) | (m >> 1) | up | dn) & vm;
}

// The stones of `own` connected to m (m within own), grown to the
// fixpoint; `d` gets the dilation of the result.
__device__ __forceinline__ unsigned fill(unsigned m, unsigned own,
                                         unsigned vm, unsigned& d) {
  for (int steps = 0;; ++steps) {
    DG_ASSERT(steps <= NN);
    d = dilate(m, vm);
    const unsigned n = m | (d & own);
    if (!__any_sync(FULL, n != m)) return m;
    m = n;
  }
}

// The stones of `own` with at most one empty neighbour (E: the empty
// points).  A chain on fewer than two liberties lies within them.
__device__ __forceinline__ unsigned tight(unsigned own, unsigned E,
                                          unsigned vm) {
  unsigned eu = __shfl_up_sync(FULL, E, 1);
  const unsigned ed = __shfl_down_sync(FULL, E, 1);
  if (lane_id() == 0) eu = 0;
  const unsigned el = E << 1, er = E >> 1;
  const unsigned two = (eu & ed) | ((eu | ed) & (el | er)) | (el & er);
  return own & ~two & vm;
}

// min(liberties, 2) of the chain of the stone s (a one-point mask of
// `own`; `low` = tight(own)); `m` gets the chain when it has fewer than two.
__device__ __forceinline__ int small_libs(unsigned s, unsigned own,
                                          unsigned low, unsigned E,
                                          unsigned vm, unsigned& m) {
  m = s;
  if (!any(s & low)) return 2;
  unsigned d;
  m = fill(s, low, vm, d);
  if (any(d & own & ~low)) return 2;
  return min(count(d & E), 2);
}

// The neighbours of p in NBR order (-1 off the board), what is on them
// (0 empty, 1 a stone of `mine`, 2 of `theirs`, 3 off the board) and
// whether they lie in the mask `known`; one batch of nine shuffles.
struct Around {
  int q[4], v[4];
  bool known[4];
  bool empty;    // p itself is empty
};

__device__ __forceinline__ Around around(Pt p, unsigned mine, unsigned theirs,
                                         unsigned known) {
  const int rows[3] = {p.r > 0 ? p.r - 1 : p.r, p.r,
                       p.r < N - 1 ? p.r + 1 : p.r};
  unsigned m[3], t[3], k[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = __shfl_sync(FULL, mine, rows[i]);
    t[i] = __shfl_sync(FULL, theirs, rows[i]);
    k[i] = __shfl_sync(FULL, known, rows[i]);
  }
  // row and shift of each neighbour's bit: up, left, right, down
  const int ri[4] = {0, 1, 1, 2};
  const bool on[4] = {p.r > 0, p.c > 0, p.c < N - 1, p.r < N - 1};
  const int q[4] = {p.p - N, p.p - 1, p.p + 1, p.p + N};
  const int sh[4] = {p.c, p.c - 1, p.c + 1, p.c};
  Around o;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int s = on[d] ? sh[d] : 0;
    o.q[d] = on[d] ? q[d] : -1;
    o.v[d] = !on[d] ? 3 : (((m[ri[d]] >> s) & 1u)
                           ? 1 : (((t[ri[d]] >> s) & 1u) ? 2 : 0));
    o.known[d] = on[d] && ((k[ri[d]] >> s) & 1u);
  }
  o.empty = !(((m[1] | t[1]) >> p.c) & 1u);
  return o;
}

// The stones of rows p.r - 2 .. p.r + 2 (rows off the board full), from
// which the empty points within two steps of p are read.
struct Window {
  unsigned s[5];
  int r0;        // the row of s[0]
};

__device__ __forceinline__ Window window(Pt p, unsigned stones) {
  Window w;
  w.r0 = p.r - 2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r = w.r0 + i;
    const unsigned v = __shfl_sync(FULL, stones, r < 0 ? 0 : min(r, N - 1));
    w.s[i] = r >= 0 && r < N ? v : ROW;
  }
  return w;
}

__device__ __forceinline__ bool empty_at(const Window& w, int r, int c) {
  return c >= 0 && c < N && !((w.s[r - w.r0] >> c) & 1u);
}

// The chains of `theirs` next to p: each one's mask (whole when it has
// fewer than two liberties) and min(liberties, 2), exact for `known`, a
// chain of `theirs` whose mask is kept.
struct Look {
  Around n;
  unsigned m[4];
  int l[4];
};

__device__ __forceinline__ void look(Pt p, unsigned mine, unsigned theirs,
                                     unsigned known, unsigned vm, Look& o) {
  const unsigned E = ~(mine | theirs) & vm;
  o.n = around(p, mine, theirs, known);
  int known_libs = -1;
  unsigned low = 0;
  bool have_low = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o.m[k] = 0;
    o.l[k] = 2;
    if (o.n.v[k] != 2) continue;
    const Pt y = pt(o.n.q[k]);
    if (o.n.known[k]) {
      if (known_libs < 0) known_libs = count(dilate(known, vm) & E);
      o.m[k] = known;
      o.l[k] = known_libs;
      continue;
    }
    if (!have_low) {
      low = tight(theirs, E, vm);
      have_low = true;
    }
    o.l[k] = small_libs(bit(y), theirs, low, E, vm, o.m[k]);
  }
}

// Play a stone of `mine` at the empty point p: the chains of `theirs` next
// to it left without a liberty are captured (`known` is cleared if it is
// one of them).  `o` gets the chains of `theirs` next to p afterwards.
__device__ __forceinline__ void place(Pt p, unsigned& mine, unsigned& theirs,
                                      unsigned& known, unsigned vm, Look& o) {
  DG_ASSERT(!has(mine | theirs, p));
  mine |= bit(p);
  look(p, mine, theirs, known, vm, o);
  unsigned cap = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (o.n.v[k] == 2 && o.l[k] == 0) cap |= o.m[k];
  if (any(cap)) {
    theirs &= ~cap;
    if (any(known & cap)) known = 0;
    look(p, mine, theirs, known, vm, o);
  }
}

// board_fast.rs:216-243: may `mine` play at p (p < 0: never)?  `known` is
// a chain with `known_libs` liberties.
__device__ __forceinline__ bool valid_at(int p, unsigned mine,
                                         unsigned theirs, unsigned known,
                                         int known_libs, unsigned vm) {
  if (p < 0) return false;
  const Around n = around(pt(p), mine, theirs, known);
  if (!n.empty) return false;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n.v[k] == 0) return true;
  const unsigned E = ~(mine | theirs) & vm;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (n.v[k] != 1 && n.v[k] != 2) continue;
    const Pt y = pt(n.q[k]);
    const unsigned own = n.v[k] == 1 ? mine : theirs;
    unsigned m;
    const int l = n.known[k]
        ? known_libs : small_libs(bit(y), own, tight(own, E, vm), E, vm, m);
    if (n.v[k] == 1 ? l >= 2 : l == 1) return true;
  }
  return false;
}

// ladder.rs:34-42: is a chain of `atk` next to the chain c in atari?
__device__ __forceinline__ bool counter(unsigned c, unsigned atk, unsigned E,
                                        unsigned vm) {
  const unsigned low = tight(atk, E, vm);
  unsigned cand = dilate(c, vm) & low;
  while (any(cand)) {
    const int src = __ffs(__ballot_sync(FULL, cand != 0u)) - 1;
    const unsigned s = lane_id() == src ? cand & (0u - cand) : 0u;
    unsigned d;
    const unsigned x = fill(s, low, vm, d);
    if (!any(d & atk & ~low) && count(d & E) == 1) return true;
    cand &= ~x;
  }
  return false;
}

// Empty neighbours of e other than a (the exploration-order heuristic),
// both within the window.
__device__ __forceinline__ int after_libs(const Window& w, int a, int e) {
  const Pt x = pt(e), y = pt(a);
  const int dr[4] = {-1, 0, 0, 1}, dc[4] = {0, -1, 1, 0};
  int libs = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = x.r + dr[k], c = x.c + dc[k];
    libs += empty_at(w, r, c) && !(r == y.r && c == y.c);
  }
  return libs;
}

// The exact DFS of go/ladder.py::run_chases for one warp: the attacker
// (stones A) plays at `attack` against the defender (stones D); K is the
// chased chain (a chain of D, or no stones).  True when some line captures
// within `budget` rungs.
__device__ bool chase(unsigned A, unsigned D, unsigned K, int attack,
                      int budget, int stack_cap, Slot* stack, int16_t* satk,
                      unsigned vm) {
  const int ln = lane_id();
  int sp = 0;
  for (int depth = 0; depth < budget; ++depth) {
    // the attacker plays; the first adjacent defender chain in atari that
    // cannot counter-capture and whose liberty is playable extends
    Look la;
    place(pt(attack), A, D, K, vm, la);
    const unsigned E = ~(A | D) & vm;
    int ext = -1;
    unsigned C = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ext >= 0 || la.n.v[k] != 2 || la.l[k] != 1) continue;
      const int lib = first_point(dilate(la.m[k], vm) & E);
      if (lib < NN && !counter(la.m[k], A, E, vm) &&
          valid_at(lib, D, A, la.m[k], 1, vm)) {
        ext = lib;
        C = la.m[k];
      }
    }
    int status;  // 0 = branch, 1 = captured, 2 = this line fails
    int dl = 0;
    Look le;
    if (ext < 0) {
      status = 2;
    } else {
      const Pt e = pt(ext);
      unsigned none = 0;
      place(e, D, A, none, vm, le);
      unsigned d;
      K = fill(C | bit(e), D, vm, d);
      dl = count(d & ~(A | D) & vm);
      bool self_atari = false;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        self_atari |= le.n.v[k] == 2 && le.l[k] == 1;
      status = dl <= 1 ? 1 : ((dl >= 3 || self_atari) ? 2 : 0);
    }
    if (status == 1) return true;
    int c1 = -1, c2 = -1;
    if (status == 0) {
      // the attacker's playable points next to the extension: an empty
      // point with an empty neighbour is, read from one window of rows
      const Pt e = pt(ext);
      const Window win = window(e, A | D);
      const int dr[4] = {-1, 0, 0, 1}, dc[4] = {0, -1, 1, 0};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int y = le.n.q[k], r = e.r + dr[k], c = e.c + dc[k];
        if (c2 >= 0 || y < 0 || !empty_at(win, r, c)) continue;
        const bool ok = empty_at(win, r - 1, c) || empty_at(win, r, c - 1) ||
                        empty_at(win, r, c + 1) || empty_at(win, r + 1, c) ||
                        valid_at(y, A, D, K, dl, vm);
        if (!ok) continue;
        if (c1 < 0) c1 = y;
        else c2 = y;
      }
      if (c2 >= 0 && after_libs(win, c2, c1) > after_libs(win, c1, c2)) {
        const int t = c1;
        c1 = c2;
        c2 = t;
      }
    }
    if (status == 0 && c1 >= 0) {
      if (c2 >= 0 && sp < stack_cap) {
        DG_ASSERT(sp >= 0 && sp < STACK_CAP);
        __syncwarp();
        stack[sp].a[ln] = A;
        stack[sp].d[ln] = D;
        stack[sp].k[ln] = K;
        if (ln == 0) satk[sp] = (int16_t)c2;
        __syncwarp();
        ++sp;
      }
      attack = c1;
    } else if (sp > 0) {
      --sp;
      DG_ASSERT(sp >= 0 && sp < STACK_CAP);
      A = stack[sp].a[ln];
      D = stack[sp].d[ln];
      K = stack[sp].k[ln];
      attack = satk[sp];
    } else {
      return false;
    }
  }
  return false;
}

__global__ void __launch_bounds__(THREADS)
ladder_planes_kernel(const int32_t* __restrict__ stones,
                     const int32_t* __restrict__ cid,
                     const int32_t* __restrict__ to_move, int budget,
                     int stack_cap, uint8_t* __restrict__ cap_o,
                     uint8_t* __restrict__ esc_o, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int ln = t & 31;
  DG_ASSERT(b >= 0 && b < batch);
  const int color = to_move[b] == 2 ? 2 : 1;
  const int opp = 3 - color;

  for (int q = t; q < NP; q += THREADS) {
    const int v = q < NN ? stones[b * NP + q] : 0;
    const int c = cid[b * NP + q];
    const bool stone = q < NN && is_stone(v);
    sm.st0[q] = (int8_t)(stone ? v : 0);
    sm.cid0[q] = (int16_t)(stone && c >= 0 && c < NN ? c : (q < NN ? q : 0));
    sm.libs0[q] = 0;
  }
  if (t < 32) {
    sm.rows[0][t] = 0;
    sm.rows[1][t] = 0;
  }
  if (t == 0) sm.next_job = 0;
  __syncthreads();
  add_liberties(sm.st0, sm.cid0, sm.libs0, t, THREADS);
  for (int r = w; r < N; r += WARPS) {   // the stones as bitboard rows
    const int v = ln < N ? sm.st0[r * N + ln] : 0;
    const unsigned black = __ballot_sync(FULL, v == 1);
    const unsigned white = __ballot_sync(FULL, v == 2);
    if (ln == 0) {
      sm.rows[0][r] = black;
      sm.rows[1][r] = white;
    }
  }
  __syncthreads();

  // candidates for the player to move: pseudo-legal points next to an
  // opponent chain on two liberties (capture) / an own chain in atari
  // (escape)
  for (int q = t; q < NP; q += THREADS) {
    bool cap = false, esc = false;
    if (q < NN && sm.st0[q] == 0) {
      bool ok = false;
      for (int k = 0; k < 4; ++k) {
        const int y = nbr(q, k);
        if (y < 0) continue;
        const int v = sm.st0[y];
        const int l = is_stone(v) ? sm.libs0[sm.cid0[y]] : 0;
        ok |= v == 0 || (v == color && l >= 2) || (v == opp && l == 1);
        cap |= v == opp && l == 2;
        esc |= v == color && l == 1;
      }
      cap &= ok;
      esc &= ok;
    }
    sm.cap_flag[q] = cap;
    sm.esc_flag[q] = esc;
  }
  __syncthreads();
  if (w == 0) {  // compact both candidate sets, in point order
    int nc = 0, ne = 0;
    const unsigned below = (1u << ln) - 1u;
    for (int q0 = 0; q0 < NN; q0 += 32) {
      const int q = q0 + ln;
      const bool fc = q < NN && sm.cap_flag[q];
      const bool fe = q < NN && sm.esc_flag[q];
      const unsigned mc = __ballot_sync(FULL, fc);
      const unsigned me = __ballot_sync(FULL, fe);
      DG_ASSERT(nc + __popc(mc) <= NP && ne + __popc(me) <= NP);
      if (fc) sm.cap_list[nc + __popc(mc & below)] = (int16_t)q;
      if (fe) sm.esc_list[ne + __popc(me & below)] = (int16_t)q;
      nc += __popc(mc);
      ne += __popc(me);
    }
    if (ln == 0) {
      sm.ncap = nc;
      sm.nesc = ne;
    }
  }
  __syncthreads();
  for (int q = t; q < NP; q += THREADS) {
    sm.cap_flag[q] = 0;
    sm.esc_flag[q] = 0;
  }
  __syncthreads();

  const unsigned vm = ln < N ? ROW : 0u;
  const unsigned own = sm.rows[color - 1][ln];
  const unsigned other = sm.rows[opp - 1][ln];
  const int ncap = sm.ncap;
  const int njobs = ncap + sm.nesc;
  for (;;) {
    int j = 0;
    if (ln == 0) j = atomicAdd(&sm.next_job, 1);
    j = __shfl_sync(FULL, j, 0);
    if (j >= njobs) break;
    DG_ASSERT(j >= 0 && j < 2 * NP);
    if (j < ncap) {
      const int p = sm.cap_list[j];
      const bool captured = chase(own, other, 0u, p, budget, stack_cap,
                                  sm.stack[w], sm.satk[w], vm);
      DG_ASSERT(p >= 0 && p < NN);
      if (ln == 0 && captured) sm.cap_flag[p] = 1;
    } else {
      // escape: extend to q (the chain must then have two liberties),
      // and every playable counter-attack must fail as a ladder
      const int q = sm.esc_list[j - ncap];
      const Pt e = pt(q);
      unsigned D = own, A = other, none = 0;
      Look lq;
      place(e, D, A, none, vm, lq);
      unsigned d;
      const unsigned K = fill(bit(e), D, vm, d);
      bool escaped = count(d & ~(A | D) & vm) == 2;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int a = lq.n.q[k];
        if (!escaped || !valid_at(a, A, D, K, 2, vm)) continue;
        escaped = !chase(A, D, K, a, budget, stack_cap, sm.stack[w],
                         sm.satk[w], vm);
      }
      if (ln == 0 && escaped) sm.esc_flag[q] = 1;
    }
  }
  __syncthreads();
  for (int q = t; q < NN; q += THREADS) {
    cap_o[b * NN + q] = sm.cap_flag[q];
    esc_o[b * NN + q] = sm.esc_flag[q];
  }
}

}  // namespace

extern "C" {

// Launches one block per board on `stream`; returns cudaGetLastError().
// `stack_cap` is clamped to [0, STACK_CAP].
int dg_ladder_planes(const void* stones, const void* cid, const void* to_move,
                     int budget, int stack_cap, void* cap_o, void* esc_o,
                     int batch, void* stream) {
  stack_cap = stack_cap < 0 ? 0 : (stack_cap > STACK_CAP ? STACK_CAP
                                                         : stack_cap);
  ladder_planes_kernel<<<batch, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      (const int32_t*)stones, (const int32_t*)cid, (const int32_t*)to_move,
      budget < 0 ? 0 : budget, stack_cap, (uint8_t*)cap_o, (uint8_t*)esc_o,
      batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
