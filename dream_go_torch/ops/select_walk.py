"""The search's batched root->leaf PUCT walk over the array trees.

Replaces no Pallas kernel: the JAX package runs the walk as a
``jax.lax.while_loop`` over depth (`dream_go_tpu/mcts/search.py:430`,
``_select_flat``).  :func:`select_walk_plain` is that loop in PyTorch: a
few dozen small launches a level for the whole batch and one host
synchronisation a level, run until the deepest board stops.  On a CUDA
device :func:`select_walk` launches ``csrc/select_walk.cu`` instead (one
warp a board, each walking its own tree; see the source's note), built with
``nvcc`` and bound with ``ctypes`` (:mod:`dream_go_torch.ops.build`); its
outputs equal the plain walk's bit for bit.

The tree layout is the search's (`mcts/search.py`, ``Tree``): node fields
[B, C, ...], root fields [B, A]; the root holds full-width child, visit and
value arrays, non-root nodes ``K`` sparse slots, and every node its bf16
prior row and a candidacy bitset (:func:`pack_cand`).  Each function
returns ``(node, action, k_exit, path_n, path_k, root_a)``, all int32: the
leaf's parent node [B], the chosen action [B], the parent's slot index
when the walk ended on an existing edge (depth-cap re-expansion; -1 for a
new edge) [B], the visited chain ``path_n`` [B, D] (-1-padded,
``path_n[:, 0] == 0``, D = min(C, ``MAX_BACKUP_DEPTH``)), the slot chosen
at each chain node ``path_k`` [B, D], and the root action [B].

:func:`select_walk_checked` launches the kernel's bounds-checked build
(``-DDG_CHECK``), whose device-side asserts trap on a node, slot, action or
child index out of range.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..go.topology import PASS
from ..utils import spans
from ..utils.numerics import fma as _fma
from . import build

A = PASS + 1  # actions: 361 points + pass
NCW = 12  # candidate bitset words (12 x 32 >= 362)
MAX_BACKUP_DEPTH = 128
NEG_INF = float("-inf")

#: kernel launches made by :func:`select_walk` (CPU calls do not count)
launches = 0


def pack_cand(c: torch.Tensor) -> torch.Tensor:
    """bool[..., A] -> int32[..., NCW] bitset (uint32 bit patterns)."""
    pad = torch.zeros(c.shape[:-1] + (NCW * 32 - A,), dtype=torch.bool,
                      device=c.device)
    cp = torch.cat([c, pad], -1).reshape(c.shape[:-1] + (NCW, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=c.device)
    return (cp.to(torch.int64) << shifts).sum(-1).to(torch.int32)


def unpack_cand(w: torch.Tensor) -> torch.Tensor:
    """int32[..., NCW] bitset -> bool[..., A]."""
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    bits = (w[..., :, None] >> shifts) & 1
    return bits.reshape(w.shape[:-1] + (NCW * 32,))[..., :A].bool()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, C, ...] -> [B*C, ...] view of the same storage."""
    return x.view((-1,) + tuple(x.shape[2:]))


def select_walk_plain(t, uct_exp, fpu_reduce, batch: int, cap: int):
    """The walk in plain PyTorch, a loop over depth with a device-side
    ``done`` mask and one host sync per level (see the module
    docstring)."""
    dev = t.size.device
    base = torch.arange(batch, device=dev) * cap
    node_n, value0 = _flat(t.node_n), _flat(t.value0)
    prior, cand = _flat(t.prior), _flat(t.cand)
    slot_action, slot_n = _flat(t.slot_action), _flat(t.slot_n)
    slot_w, slot_child = _flat(t.slot_w), _flat(t.slot_child)

    n_tot0 = node_n[base].float()
    v00 = value0[base]
    rp0 = prior[base].float()
    cand0 = unpack_cand(cand[base])
    en0 = t.root_edge_n
    q0 = torch.where(en0 > 0, t.root_edge_w / torch.clamp(en0, min=1),
                     v00[:, None])
    bonus0 = (uct_exp.at(n_tot0) * torch.sqrt(1.0 + n_tot0))[:, None] \
        / (1.0 + en0.float())
    score0 = _fma(rp0, bonus0, q0)
    score0 = torch.where(cand0 & torch.isfinite(score0), score0, NEG_INF)
    root_a = torch.where(cand0.any(1), torch.argmax(score0, 1),
                         A - 1).to(torch.int32)

    def puct_nonroot(m):
        g = base + m
        n_tot = node_n[g].float()
        fpu = torch.clamp(value0[g] - fpu_reduce.at(n_tot), min=0.0)
        u = uct_exp.at(n_tot) * torch.sqrt(1.0 + n_tot)
        sa = slot_action[g]
        sn = slot_n[g]
        occ = sa >= 0
        rowp = prior[g].float()
        q_s = torch.where(sn > 0, slot_w[g] / torch.clamp(sn, min=1),
                          fpu[:, None])
        p_s = rowp.gather(1, torch.clamp(sa, min=0).long())
        s_s = _fma(p_s, u[:, None] / (1.0 + sn.float()), q_s)
        s_s = torch.where(occ & torch.isfinite(s_s), s_s, NEG_INF)
        k_best = torch.argmax(s_s, 1)
        s_best = s_s.max(1).values

        candm = unpack_cand(cand[g])
        in_slots = torch.zeros(batch, A + 1, dtype=torch.bool, device=dev)
        in_slots.scatter_(1, torch.where(occ, sa, A).long(), True)
        un_mask = candm & ~in_slots[:, :A]
        p_un = torch.where(un_mask, rowp, NEG_INF)
        a_best = torch.argmax(p_un, 1)
        su_best = _fma(p_un.max(1).values, u, fpu)

        any_un = un_mask.any(1)
        slots_full = occ.all(1)
        use_slot = occ.any(1) & ((s_best >= su_best) | slots_full | ~any_un)
        action = torch.where(
            use_slot, sa.gather(1, k_best[:, None])[:, 0],
            torch.where(any_un, a_best, A - 1).to(torch.int32))
        kk = torch.where(use_slot, k_best, -1).to(torch.int32)
        return action.to(torch.int32), kk

    d = min(cap, MAX_BACKUP_DEPTH)
    path_n = torch.full((batch, d), -1, dtype=torch.int32, device=dev)
    path_n[:, 0] = 0
    path_k = torch.full((batch, d), -1, dtype=torch.int32, device=dev)

    # the root advance is resolved once, outside the loop: afterwards a
    # lane is never at the root again
    child0 = t.root_child.gather(1, root_a[:, None].long())[:, 0]
    adv0 = child0 >= 0
    node = torch.where(adv0, child0, 0)
    a1, k1 = puct_nonroot(node)
    action = torch.where(adv0, a1, root_a)
    kc = torch.where(adv0, k1, -1)
    path_n[:, 1] = torch.where(adv0, node, -1)
    path_k[:, 1] = torch.where(adv0, kc, -1)
    done = ~adv0
    depth = 2
    while depth < d:
        with spans.span("search.select.wait"):
            finished = bool(done.all())
        if finished:
            break
        child = slot_child[base + node].gather(
            1, torch.clamp(kc, min=0)[:, None].long())[:, 0]
        child = torch.where(kc >= 0, child, -1)
        adv = ~done & (child >= 0)
        node = torch.where(adv, child, node)
        action_new, k_new = puct_nonroot(node)
        action = torch.where(adv, action_new, action)
        kc = torch.where(adv, k_new, kc)
        path_n[:, depth] = torch.where(adv, node, -1)
        path_k[:, depth] = torch.where(adv, kc, -1)
        done = done | (child < 0)
        depth += 1
    if spans.active():
        # the root's level and each trip of the loop walk every lane
        spans.count("search.select.iterations", depth - 2)
        spans.count("search.select.lane_trips", (depth - 1) * batch)
    return node, action, kc, path_n, path_k, root_a


@functools.lru_cache(maxsize=None)
def _kernel(check: bool):
    fn = build.load("select_walk", check).dg_select_walk
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _knots(uct_exp, fpu_reduce, device: str) -> torch.Tensor:
    """f32 knots of the two schedules, as ``Schedule.at`` rounds them:
    uct_exp's visits and values, then fpu_reduce's."""
    vals = [x for s in (uct_exp, fpu_reduce)
            for x in [k for k, _ in s.knots] + [v for _, v in s.knots]]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def select_walk(t, uct_exp, fpu_reduce, batch: int, cap: int):
    """The walk (see the module docstring).  CPU trees take
    :func:`select_walk_plain`; CUDA trees launch the kernel on the current
    stream, with no host synchronisation."""
    return _walk(t, uct_exp, fpu_reduce, batch, cap, check=False)


def select_walk_checked(t, uct_exp, fpu_reduce, batch: int, cap: int):
    """:func:`select_walk` with the kernel's bounds-checked build: an index
    out of range traps, and the next synchronisation raises."""
    return _walk(t, uct_exp, fpu_reduce, batch, cap, check=True)


def _walk(t, uct_exp, fpu_reduce, batch: int, cap: int, check: bool):
    global launches
    dev = t.size.device
    if dev.type == "cpu":
        return select_walk_plain(t, uct_exp, fpu_reduce, batch, cap)
    if dev.type != "cuda":
        raise ValueError(f"select_walk: unsupported device {dev}")
    if not uct_exp.knots or not fpu_reduce.knots:
        raise ValueError("select_walk: a schedule without knots")
    k = t.slot_action.shape[-1]
    d = min(cap, MAX_BACKUP_DEPTH)
    if d < 2 or k < 1:
        raise ValueError(f"select_walk: capacity {cap} and {k} slots; the "
                         "walk needs two nodes and a slot")
    i32, f32 = torch.int32, torch.float32
    node_args = [("node_n", i32, ()), ("value0", f32, ()),
                 ("prior", torch.bfloat16, (A,)), ("cand", i32, (NCW,)),
                 ("slot_action", i32, (k,)), ("slot_child", i32, (k,)),
                 ("slot_n", i32, (k,)), ("slot_w", f32, (k,))]
    root_args = [("root_child", i32), ("root_edge_n", i32),
                 ("root_edge_w", f32)]
    for name, dtype, tail in node_args:
        build.check_arg("select_walk", name, getattr(t, name), dtype,
                        (batch, cap) + tail, dev)
    for name, dtype in root_args:
        build.check_arg("select_walk", name, getattr(t, name), dtype,
                        (batch, A), dev)
    node = torch.empty(batch, dtype=i32, device=dev)
    action = torch.empty(batch, dtype=i32, device=dev)
    k_exit = torch.empty(batch, dtype=i32, device=dev)
    root_a = torch.empty(batch, dtype=i32, device=dev)
    path_n = torch.empty(batch, d, dtype=i32, device=dev)
    path_k = torch.empty(batch, d, dtype=i32, device=dev)
    if batch == 0:
        return node, action, k_exit, path_n, path_k, root_a
    knots = _knots(uct_exp, fpu_reduce, str(dev))
    ptrs = [getattr(t, name).data_ptr() for name, _, _ in node_args] \
        + [getattr(t, name).data_ptr() for name, _ in root_args] \
        + [knots.data_ptr()]
    build.launch("select_walk", _kernel(check), dev, *ptrs,
                 len(uct_exp.knots), len(fpu_reduce.knots),
                 *[x.data_ptr() for x in (node, action, k_exit, path_n,
                                          path_k, root_a)],
                 batch, cap, k, d)
    launches += 1
    if spans.active():
        spans.count("search.select.launches")
        # the walk's levels as the plain loop counts them: the deepest
        # board's, the root's included, at most d - 1, times the boards
        deepest = (path_n[:, 1:] >= 0).sum(1).max()
        spans.count_device("search.select.lane_trips",
                           torch.clamp(deepest + 1, max=d - 1) * batch)
    return node, action, k_exit, path_n, path_k, root_a
