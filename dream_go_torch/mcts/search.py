"""Batched MCTS: PUCT search over array trees, all games in lockstep.

Port of `dream_go_tpu/mcts/search.py`.  One fixed-capacity array tree per
game; every simulation selects a leaf in each game's tree, applies the
action and featurizes the leaf (on the fused path, one ``leaf_step``
kernel launch for the whole batch, plus one ladder-kernel launch when the
net takes planes 30/31; unfused with ``step_kernel``, one ``env_step``
launch with a one-hot weight), runs one batched network evaluation, and
inserts/backs up.  The tree layout, formulas and reference behaviours
are those of the JAX package:

- two-tier edges: the root holds full-width [362] child/visit/value
  arrays, non-root nodes ``children_slots`` sparse slots; every node keeps
  its full bf16 prior row and a candidacy bitset (`tree.rs:535-991`);
- PUCT ``Q + prior * uct_exp(n) * sqrt(1+n) / (1+count)`` with FPU at
  non-root nodes (`tree.rs:63-114,196-239`);
- a full 32-slot non-root node forces slot use, depth-cap re-expansion
  keeps the old slot's stats, and the recorded path stops at
  ``MAX_BACKUP_DEPTH``.

The JAX package evaluates ``a + b * c`` in these formulas as one fused
multiply-add (XLA contracts it); ``utils.numerics.fma`` reproduces that
rounding so the tree statistics match bit for bit.

Trees are updated in place: a search owns its trees, and the flat
``[B*C, ...]`` views used by select and backup are views of the same
storage.  The select walk is a Python loop over depth with a device-side
``done`` mask and one host sync per level.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SearchConfig
from ..go import engine, features, ladder
from ..go.engine import GoState
from ..go.options import scoring_mask, standard_mask
from ..ops import layout
from ..ops.env_step import env_step_states
from ..ops.leaf_step import leaf_step
from ..utils import spans
from ..utils.draws import draw
from ..utils.lcb import normal_lcb
from ..utils.numerics import fma as _fma
from .choose import choose

A = 362  # actions: 361 points + pass
NCW = 12  # candidate bitset words (12 x 32 >= 362)
MIN_LCB_VISITS = 80  # tree.rs:34
MAX_BACKUP_DEPTH = 128
NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# tree-resident board rows


@dataclasses.dataclass
class PackedStates:
    """Board rows in the kernel layout, narrowed for memory (i8 stones,
    i16 chain ids, 64-entry ring); widened per gathered row for
    ``leaf_step``.  Leading axes are the node indices."""

    stones: torch.Tensor  # i8[..., 384]
    cid: torch.Tensor     # i16[..., 384]
    cxp: torch.Tensor     # i32[..., 2, 384]
    hist: torch.Tensor    # i32[..., 2, 64]
    meta: torch.Tensor    # i32[..., 8]
    hashw: torch.Tensor   # i32[..., 2]
    komi: torch.Tensor    # f32[...]

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def _map(states, fn):
    """Apply ``fn`` to every field of a GoState or PackedStates."""
    return type(states)(**{k: fn(v) for k, v in states.fields().items()})


def pack_rows(states: GoState) -> PackedStates:
    """Batched GoState -> narrow kernel-layout rows (one per board)."""
    stones, cid, cxp, hist, meta, hashw = layout.pack_states(states)
    return PackedStates(
        stones=stones[:, 0].to(torch.int8),
        cid=cid[:, 0].to(torch.int16),
        cxp=cxp,
        hist=hist[:, :, :layout.RING].contiguous(),
        meta=meta[:, 0],
        hashw=hashw[:, 0, :2],
        komi=states.komi,
    )


def _widen_rows(ps: PackedStates):
    """Narrow rows -> the six wide arrays ``leaf_step`` consumes."""
    b = ps.stones.shape[0]
    return (
        ps.stones.to(torch.int32)[:, None, :],
        ps.cid.to(torch.int32)[:, None, :],
        ps.cxp.contiguous(),
        torch.cat([ps.hist, ps.hist.new_zeros(b, 2, 128 - layout.RING)], 2),
        ps.meta[:, None, :].contiguous(),
        torch.cat([ps.hashw, ps.hashw.new_zeros(b, 6)], 1)[:, None, :],
    )


def _narrow_rows(leaf_packed, komi: torch.Tensor) -> PackedStates:
    stones, cid, cxp, hist, meta, hashw = leaf_packed
    return PackedStates(
        stones=stones[:, 0].to(torch.int8),
        cid=cid[:, 0].to(torch.int16),
        cxp=cxp,
        hist=hist[:, :, :layout.RING],
        meta=meta[:, 0],
        hashw=hashw[:, 0, :2],
        komi=komi,
    )


def unpack_rows(ps: PackedStates) -> GoState:
    """Narrow rows -> batched GoState."""
    b = ps.stones.shape[0]
    template = engine.new_states(b, device=ps.stones.device)
    out = layout.unpack_states(template, *_widen_rows(ps))
    return out.replace(komi=ps.komi)


def _states_to_move(states) -> torch.Tensor:
    if isinstance(states, PackedStates):
        return states.meta[..., 0].to(torch.int8)
    return states.to_move


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


# ---------------------------------------------------------------------------
# the trees


@dataclasses.dataclass
class Tree:
    """A batch of fixed-capacity array trees: node fields are [B, C, ...],
    root fields [B, A], ``size`` [B].  Node 0 is the root."""

    states: GoState | PackedStates  # [B, C] board rows per node
    prior: torch.Tensor         # bf16[B, C, A] masked+renormalized priors
    cand: torch.Tensor          # i32[B, C, NCW] candidacy bitset
    root_child: torch.Tensor    # i32[B, A], -1 = absent
    root_edge_n: torch.Tensor   # i32[B, A]
    root_edge_w: torch.Tensor   # f32[B, A] (root perspective)
    slot_action: torch.Tensor   # i32[B, C, K], -1 = empty slot
    slot_child: torch.Tensor    # i32[B, C, K]
    slot_n: torch.Tensor        # i32[B, C, K]
    slot_w: torch.Tensor        # f32[B, C, K] (parent perspective)
    parent: torch.Tensor        # i32[B, C], -1 for root
    parent_action: torch.Tensor  # i32[B, C]
    parent_slot: torch.Tensor   # i32[B, C] (-1 when parent is root)
    node_n: torch.Tensor        # i32[B, C]
    node_w: torch.Tensor        # f32[B, C] (node-to-move perspective)
    node_m2: torch.Tensor       # f32[B, C] Welford sum of squares
    node_to_move: torch.Tensor  # i32[B, C]
    value0: torch.Tensor        # f32[B, C] net value at node
    size: torch.Tensor          # i32[B]

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)


_GAME_FIELDS = ("root_child", "root_edge_n", "root_edge_w", "size")


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, C, ...] -> [B*C, ...] view of the same storage."""
    return x.view((-1,) + tuple(x.shape[2:]))


def _sane_value(v):
    return torch.where(torch.isfinite(v), torch.clamp(v, 0.0, 1.0), 0.5)


def _masked_prior(policy, candidate):
    """Mask to candidates and renormalize; uniform when degenerate
    (`pool/policy_helper.rs:86-134`)."""
    p = torch.where(candidate & torch.isfinite(policy), policy, 0.0)
    p = torch.clamp(p, min=0.0)
    total = p.sum(-1, keepdim=True)
    cf = candidate.to(torch.float32)
    uniform = cf / torch.clamp(cf.sum(-1, keepdim=True), min=1.0)
    return torch.where(total > 1e-12, p / torch.clamp(total, min=1e-12),
                       uniform)


def _dirichlet_mix(gen, prior, candidate, beta, alpha):
    """(1-b)*p + b*Dir(alpha) over candidate entries (`dirichlet.rs`)."""
    g = draw(gen, lambda gg, n: torch._standard_gamma(torch.full(
        (n,) + prior.shape[1:], alpha, dtype=prior.dtype,
        device=prior.device), generator=gg),
        prior.shape[0])
    g = torch.where(candidate, g, 0.0)
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-12)
    return torch.where(candidate, (1.0 - beta) * prior + beta * g, prior)


def _net_input(states: GoState, cfg: SearchConfig) -> torch.Tensor:
    return features.extract_batch(states, cfg.ladder_features,
                                  cfg.feature_kernel, bool(cfg.ladders_exact),
                                  feature_set=cfg.feature_set)


def _leaf_ladder_planes(leaf_packed, cfg: SearchConfig,
                        planes: torch.Tensor) -> None:
    """Write planes 30/31 of the fused leaf features in place, from the
    leaves' kernel-layout rows, with the reader that also read the
    roots."""
    cap, esc = ladder.ladder_planes_batch(
        leaf_packed[0], leaf_packed[1], leaf_packed[4][:, 0, 0],
        bool(cfg.ladders_exact))
    b = planes.shape[0]
    planes[:, 30] = cap.to(planes.dtype).reshape(b, 19, 19)
    planes[:, 31] = esc.to(planes.dtype).reshape(b, 19, 19)


@spans.spanned("search.init_trees")
def init_trees(states: GoState, predictor, gen: torch.Generator,
               cfg: SearchConfig, num_nodes: int,
               use_scoring: torch.Tensor | None) -> Tree:
    """Evaluate the roots (batched) and allocate one tree per game."""
    value, policy = predictor(_net_input(states, cfg))
    candidate = standard_mask(states)
    if use_scoring is not None:
        candidate = torch.where(use_scoring[:, None], scoring_mask(states),
                                candidate)
    b, n, k = states.batch, num_nodes, cfg.children_slots
    dev = states.stones.device
    rows = pack_rows(states) if cfg.fused else states
    tree_states = _map(rows, lambda x: x[:, None].expand(
        (b, n) + tuple(x.shape[1:])).contiguous())
    prior = _masked_prior(policy.float(), candidate)
    if cfg.dirichlet_noise > 0:
        prior = _dirichlet_mix(gen, prior, candidate, cfg.dirichlet_noise,
                               cfg.dirichlet_alpha)
    v = _sane_value(value.float())
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    prior_t = torch.zeros(b, n, A, dtype=torch.bfloat16, device=dev)
    prior_t[:, 0] = prior.to(torch.bfloat16)
    cand_t = torch.zeros(b, n, NCW, **i32)
    cand_t[:, 0] = pack_cand(candidate)
    node_n = torch.zeros(b, n, **i32)
    node_n[:, 0] = 1
    node_w = torch.zeros(b, n, **f32)
    node_w[:, 0] = v
    return Tree(
        states=tree_states,
        prior=prior_t,
        cand=cand_t,
        root_child=torch.full((b, A), -1, **i32),
        root_edge_n=torch.zeros(b, A, **i32),
        root_edge_w=torch.zeros(b, A, **f32),
        slot_action=torch.full((b, n, k), -1, **i32),
        slot_child=torch.full((b, n, k), -1, **i32),
        slot_n=torch.zeros(b, n, k, **i32),
        slot_w=torch.zeros(b, n, k, **f32),
        parent=torch.full((b, n), -1, **i32),
        parent_action=torch.zeros(b, n, **i32),
        parent_slot=torch.full((b, n), -1, **i32),
        node_n=node_n,
        node_w=node_w,
        node_m2=torch.zeros(b, n, **f32),
        node_to_move=_states_to_move(states).to(torch.int32)[:, None]
        .expand(b, n).contiguous(),
        value0=node_w.clone(),
        size=torch.ones(b, **i32),
    )


# ---------------------------------------------------------------------------
# one simulation: select, then insert + backup


@spans.spanned("search.select")
def _select_flat(t: Tree, cfg: SearchConfig, batch: int, cap: int):
    """Batched root->leaf PUCT walk.

    Returns ``(node, action, k_exit, path_n, path_k, root_a)``: the leaf's
    parent node, the chosen action, the parent's slot index when the walk
    ended on an existing edge (depth-cap re-expansion; -1 for a new edge),
    the visited chain ``path_n[B, D]`` (-1-padded, ``path_n[:, 0] == 0``),
    the slot chosen at each chain node ``path_k``, and the root action.
    """
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
    bonus0 = (cfg.uct_exp.at(n_tot0) * torch.sqrt(1.0 + n_tot0))[:, None] \
        / (1.0 + en0.float())
    score0 = _fma(rp0, bonus0, q0)
    score0 = torch.where(cand0 & torch.isfinite(score0), score0, NEG_INF)
    root_a = torch.where(cand0.any(1), torch.argmax(score0, 1),
                         A - 1).to(torch.int32)

    def puct_nonroot(m):
        g = base + m
        n_tot = node_n[g].float()
        fpu = torch.clamp(value0[g] - cfg.fpu_reduce.at(n_tot), min=0.0)
        u = cfg.uct_exp.at(n_tot) * torch.sqrt(1.0 + n_tot)
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
        spans.count_device("search.select.board_levels",
                           (path_n[:, 1:] >= 0).sum())
    return node, action, kc, path_n, path_k, root_a


@spans.spanned("search.backup")
def _insert_backup_flat(t: Tree, node, action, k_exit, path_n, path_k,
                        root_a, leaf_rows, value, policy, use_scoring,
                        enabled, candidate, batch: int, cap: int) -> Tree:
    """Attach the evaluated leaf under ``(node, action)`` and back its
    value up the recorded chain, in place.  A full tree, or a non-root
    parent without a free slot, still backs the value up but inserts
    nothing; ``enabled=False`` (rollout budget spent) makes the call a
    no-op for that game.  Guarded writes rewrite the target row with its
    old value, and guarded adds add zero, so every write stays inside its
    own game's rows."""
    dev = t.size.device
    k = t.slot_action.shape[2]
    base = torch.arange(batch, device=dev) * cap
    acts = torch.arange(A, device=dev)
    slots = torch.arange(k, device=dev)
    slot_action, slot_child = _flat(t.slot_action), _flat(t.slot_child)
    slot_n, slot_w = _flat(t.slot_n), _flat(t.slot_w)
    node_n, node_w, node_m2 = _flat(t.node_n), _flat(t.node_w), \
        _flat(t.node_m2)
    node_to_move = _flat(t.node_to_move)

    has_room = t.size < cap
    if enabled is not None:
        node = torch.where(enabled, node, -1)
    at_root = node == 0
    nonroot = node > 0

    sa_parent = slot_action[torch.where(nonroot, base + node, 0)]  # [B, K]
    free = sa_parent < 0
    first_free = torch.argmax(free.to(torch.int8), 1).to(torch.int32)
    free_k = torch.where(k_exit >= 0, k_exit, first_free)
    slot_ok = (k_exit >= 0) | free.any(1)
    can = has_room & (at_root | (nonroot & slot_ok))
    new = torch.clamp(t.size, max=cap - 1)
    value = _sane_value(value.float())

    if candidate is None:
        candidate = standard_mask(leaf_rows)
        if use_scoring is not None:
            candidate = torch.where(use_scoring[:, None],
                                    scoring_mask(leaf_rows), candidate)
    prior = _masked_prior(policy.float(), candidate)

    idx_new = base + new

    def setr(buf, row):
        flat = _flat(buf)
        old = flat[idx_new]
        m = can.reshape((-1,) + (1,) * (old.dim() - 1))
        flat[idx_new] = torch.where(m, row.to(flat.dtype), old)

    leaf_to_move = _states_to_move(leaf_rows).to(torch.int32)
    for name, rowv in leaf_rows.fields().items():
        setr(getattr(t.states, name), rowv)
    setr(t.prior, prior.to(torch.bfloat16))
    setr(t.cand, pack_cand(candidate))
    setr(t.parent, node)
    setr(t.parent_action, action)
    setr(t.parent_slot, torch.where(at_root, -1, free_k))
    setr(t.node_to_move, leaf_to_move)
    setr(t.value0, value)
    t.size += can.to(torch.int32)

    # link the new edge: root one-hot rewrite, or the parent's slot row
    ok_root = can & at_root
    hot_new = (acts[None, :] == action[:, None]) & ok_root[:, None]
    t.root_child.copy_(torch.where(hot_new, new[:, None], t.root_child))
    ok_slot = can & nonroot
    srow = base + torch.clamp(node, min=0)
    khot = (slots[None, :] == free_k[:, None]) & ok_slot[:, None]  # [B, K]
    slot_action[srow] = torch.where(khot, action[:, None], slot_action[srow])
    slot_child[srow] = torch.where(khot, new[:, None], slot_child[srow])

    # whole-chain backup: every chain node once per simulation
    valid = path_n >= 0                                     # [B, D]
    if enabled is not None:
        valid = valid & enabled[:, None]
    g = base[:, None] + torch.clamp(path_n, min=0)          # [B, D]
    x = torch.where(node_to_move[g] == leaf_to_move[:, None],
                    value[:, None], 1.0 - value[:, None])
    cnt = node_n[g].float()
    wpre = node_w[g]
    mean_prev = torch.where(cnt > 0, wpre / torch.clamp(cnt, min=1.0), x)
    mean_next = (wpre + x) / (cnt + 1.0)
    gf = g.reshape(-1)
    node_m2.index_add_(0, gf, torch.where(
        valid, (x - mean_prev) * (x - mean_next), 0.0).reshape(-1))
    node_n.index_add_(0, gf, valid.to(torch.int32).reshape(-1))
    node_w.index_add_(0, gf, torch.where(valid, x, 0.0).reshape(-1))
    # seed the new leaf's stats (the chain excludes the leaf)
    node_n[idx_new] = torch.where(can, 1, node_n[idx_new])
    node_w[idx_new] = torch.where(can, value, node_w[idx_new])

    # edge into chain node j gets the child's value in the parent's
    # perspective (1 - x_j): j = 1 is a root edge, j >= 2 the parent's slot
    hot_r = (acts[None, :] == root_a[:, None]) & valid[:, 1:2]
    hot_seed = (acts[None, :] == action[:, None]) & ok_root[:, None]
    t.root_edge_n += hot_r.to(torch.int32) + hot_seed.to(torch.int32)
    t.root_edge_w.copy_(t.root_edge_w + hot_r * (1.0 - x[:, 1:2])
                        + hot_seed * (1.0 - value)[:, None])

    evalid = valid[:, 2:]                                   # [B, D-2]
    erow = (base[:, None] + torch.clamp(path_n[:, 1:-1], min=0)).reshape(-1)
    khot_c = (slots[None, None, :] == path_k[:, 1:-1, None]) \
        & evalid[:, :, None]                                # [B, D-2, K]
    slot_n.index_add_(0, erow, khot_c.to(torch.int32).reshape(-1, k))
    slot_w.index_add_(0, erow, torch.where(
        khot_c, (1.0 - x[:, 2:])[:, :, None], 0.0).reshape(-1, k))
    # the leaf's own slot edge (parent `node`, slot free_k)
    slot_n.index_add_(0, srow, khot.to(torch.int32))
    slot_w.index_add_(0, srow, torch.where(khot, (1.0 - value)[:, None],
                                           0.0))
    return t


# ---------------------------------------------------------------------------
# batched search driver


def run_search(trees: Tree, predictor, cfg: SearchConfig, num_sims: int,
               use_scoring: torch.Tensor | None,
               budget: torch.Tensor | None = None, start: int = 0) -> Tree:
    """Run ``num_sims`` lockstep simulations across the game batch.

    ``budget`` (optional i32[B]) caps per-game simulations: game ``g``
    stops contributing once ``start + i >= budget[g]``.
    """
    batch, cap = trees.node_n.shape
    base = torch.arange(batch, device=trees.size.device) * cap
    for i in range(num_sims):
        with spans.span("search.simulation", request=start + i):
            spans.count("search.simulations")
            candidate = None
            node, action, k_exit, path_n, path_k, root_a = _select_flat(
                trees, cfg, batch, cap)
            parent = _map(trees.states, lambda x: _flat(x)[base + node])
            if cfg.fused:
                if cfg.feature_set != "v1":
                    raise ValueError(
                        "the fused leaf kernel computes V1 planes")
                with spans.span("search.leaf"):
                    leaf_packed, feats_k, cand = leaf_step(
                        *_widen_rows(parent), action, parent.komi)
                    leaf_states = _narrow_rows(leaf_packed, parent.komi)
                    planes = feats_k[:, :, :361].reshape(batch, 32, 19, 19)
                    if cfg.ladder_features:
                        _leaf_ladder_planes(leaf_packed, cfg, planes)
                    candidate = torch.cat(
                        [cand, torch.ones_like(cand[:, :1])], dim=1)
                if use_scoring is not None:
                    with spans.span("search.scoring_mask"):
                        candidate = torch.where(
                            use_scoring[:, None],
                            scoring_mask(unpack_rows(leaf_states)), candidate)
                value, policy = predictor.planes(planes)
            else:
                with spans.span("search.leaf"):
                    if cfg.step_kernel:
                        onehot = (torch.arange(engine.PASS,
                                               device=action.device)[None, :]
                                  == action[:, None]).to(torch.float32)
                        leaf_states, _ = env_step_states(parent, onehot, 0)
                    else:
                        leaf_states = engine.step(parent, action)
                    feats = _net_input(leaf_states, cfg)
                value, policy = predictor(feats)
            en = None if budget is None else (start + i) < budget
            _insert_backup_flat(
                trees, node, action, k_exit, path_n, path_k, root_a,
                leaf_states, value, policy,
                use_scoring if candidate is None else None, en, candidate,
                batch, cap)
    return trees


def search(states: GoState, predictor, gen: torch.Generator,
           cfg: SearchConfig, num_sims: int,
           use_scoring: torch.Tensor | None = None,
           capacity: int | None = None, adaptive: bool = False,
           budget: torch.Tensor | None = None) -> Tree:
    """Full search from a batch of root states; returns the trees."""
    trees = init_trees(states, predictor, gen, cfg,
                       capacity or (num_sims + 1), use_scoring)
    if adaptive:
        return run_search_adaptive(trees, predictor, cfg, num_sims,
                                   use_scoring, budget=budget)
    return run_search(trees, predictor, cfg, num_sims, use_scoring,
                      budget=budget)


def search_done(trees: Tree, sims_remaining: torch.Tensor) -> torch.Tensor:
    """EARLY-C (`time_control/mod.rs:48-70`): bool[B], the runner-up
    cannot catch the leader with the remaining simulations."""
    visits = trees.root_edge_n
    best = visits.max(1, keepdim=True).values
    second = torch.where(visits == best, -1, visits).max(1).values
    return (best[:, 0] - torch.clamp(second, min=0)) > sims_remaining


UNSTABLE_MARGIN = 0.005


def search_unstable(trees: Tree) -> torch.Tensor:
    """UNST-N (`time_control/byo_yomi.rs:177-192` ``is_stable``, negated):
    bool[B], the most visited root child is not the highest-valued one and
    trails it by at least ``UNSTABLE_MARGIN``.  Time-managed play extends
    the search while this holds."""
    visits = root_visits(trees)
    valid = visits > 0
    qv = torch.where(valid, root_q(trees), NEG_INF)
    top_visits = torch.argmax(torch.where(valid, visits, -1), 1)
    top_value = torch.argmax(qv, 1)
    gap = qv.gather(1, top_value[:, None])[:, 0] \
        - qv.gather(1, top_visits[:, None])[:, 0]
    return (top_visits != top_value) & (gap >= UNSTABLE_MARGIN) \
        & valid.any(1)


def run_search_adaptive(trees: Tree, predictor, cfg: SearchConfig,
                        num_sims: int,
                        use_scoring: torch.Tensor | None = None,
                        check_every: int = 32,
                        budget: torch.Tensor | None = None) -> Tree:
    """Chunked search that stops once every game is decided or out of
    budget (one host sync per chunk)."""
    chunks = max(1, (num_sims + check_every - 1) // check_every)
    batch = trees.size.shape[0]
    dev = trees.size.device
    if budget is None and num_sims % check_every != 0:
        budget = torch.full((batch,), num_sims, dtype=torch.int32,
                            device=dev)
    cap = torch.full((batch,), num_sims, dtype=torch.int32, device=dev)
    if budget is not None:
        cap = torch.minimum(cap, budget.to(torch.int32))
    for i in range(chunks):
        remaining = cap - i * check_every
        done = search_done(trees, remaining) | (remaining <= 0)
        with spans.span("search.adaptive.wait"):
            finished = bool(done.all())
        if finished:
            break
        trees = run_search(trees, predictor, cfg, check_every, use_scoring,
                           budget=budget, start=i * check_every)
    return trees


# ---------------------------------------------------------------------------
# subtree reuse (`tree.rs:1225-1249` Node::forward)


def _descendant_mask(parent: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """bool[B, N]: nodes in the subtree rooted at ``c`` (pointer
    doubling)."""
    n = parent.shape[1]
    desc = torch.arange(n, device=parent.device)[None, :] == c[:, None]
    hop = parent.long()
    for _ in range(max(1, (n - 1).bit_length())):
        up = desc.gather(1, torch.clamp(hop, min=0))
        desc = desc | ((hop >= 0) & up)
        hop = torch.where(hop >= 0, hop.gather(1, torch.clamp(hop, min=0)),
                          -1)
    return desc


@spans.spanned("search.reroot")
def reroot(trees: Tree, action: torch.Tensor, gen: torch.Generator,
           cfg: SearchConfig):
    """Compact each game's subtree under root-child ``action`` to the
    front.  Returns ``(trees, valid)``; where the played move was never
    expanded (``valid`` False) the caller falls back to a fresh tree.  The
    new root keeps its statistics, gets fresh Dirichlet noise, and its
    slots are densified into the full-width root arrays."""
    b, n = trees.node_n.shape
    dev = trees.size.device
    iota = torch.arange(n, device=dev)[None, :]
    c = trees.root_child.gather(1, action[:, None].long())[:, 0]
    valid = (c >= 0) & (trees.size > 1)
    c0 = torch.clamp(c, min=0)

    desc = _descendant_mask(trees.parent, c0)
    key = torch.where(desc, iota + 1, n + 2)
    key = torch.where(iota == c0[:, None], 0, key)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    new_idx = torch.searchsorted(sorted_key, key)           # old -> new
    k = desc.sum(1)
    live = iota < k[:, None]

    def gather(buf, fill=None):
        idx = order.reshape((b, n) + (1,) * (buf.dim() - 2)).expand(
            (b, n) + tuple(buf.shape[2:]))
        out = buf.gather(1, idx)
        if fill is not None:
            m = live.reshape((b, n) + (1,) * (out.dim() - 2))
            out = torch.where(m, out, torch.tensor(fill, dtype=out.dtype,
                                                   device=dev))
        return out

    slot_action = gather(trees.slot_action, -1)
    slot_child = gather(trees.slot_child)
    remap = new_idx.gather(
        1, torch.clamp(slot_child, min=0).reshape(b, -1).long()).reshape(
            slot_child.shape).to(torch.int32)
    slot_child = torch.where((slot_child >= 0) & live[:, :, None], remap, -1)
    slot_n = gather(trees.slot_n, 0)
    slot_w = gather(trees.slot_w, 0.0)
    par = gather(trees.parent)
    parent = torch.where(live, new_idx.gather(
        1, torch.clamp(par, min=0).long()).to(torch.int32), -1)
    parent[:, 0] = -1

    prior = gather(trees.prior, 0.0)
    cand = gather(trees.cand, 0)

    # densify the new root's slots into the full-width root arrays
    sa0, sc0 = slot_action[:, 0], slot_child[:, 0]
    sn0, sw0 = slot_n[:, 0], slot_w[:, 0]
    idx0 = torch.where(sa0 >= 0, sa0, A).long()
    root_child = torch.full((b, A + 1), -1, dtype=torch.int32, device=dev)
    root_child.scatter_(1, idx0, sc0)
    root_edge_n = torch.zeros(b, A + 1, dtype=torch.int32, device=dev)
    root_edge_n.scatter_(1, idx0, sn0)
    root_edge_w = torch.zeros(b, A + 1, dtype=torch.float32, device=dev)
    root_edge_w.scatter_(1, idx0, sw0)
    slot_action[:, 0] = -1
    slot_child[:, 0] = -1
    slot_n[:, 0] = 0
    slot_w[:, 0] = 0.0

    cand0 = unpack_cand(cand[:, 0])
    root_prior = _masked_prior(prior[:, 0].float(), cand0)
    if cfg.dirichlet_noise > 0:
        root_prior = _dirichlet_mix(gen, root_prior, cand0,
                                    cfg.dirichlet_noise, cfg.dirichlet_alpha)
    prior[:, 0] = root_prior.to(torch.bfloat16)
    parent_slot = gather(trees.parent_slot, -1)
    parent_slot[:, 0] = -1

    out = Tree(
        states=_map(trees.states, gather),
        prior=prior,
        cand=cand,
        root_child=root_child[:, :A].contiguous(),
        root_edge_n=root_edge_n[:, :A].contiguous(),
        root_edge_w=root_edge_w[:, :A].contiguous(),
        slot_action=slot_action,
        slot_child=slot_child,
        slot_n=slot_n,
        slot_w=slot_w,
        parent=parent,
        parent_action=gather(trees.parent_action, 0),
        parent_slot=parent_slot,
        node_n=gather(trees.node_n, 0),
        node_w=gather(trees.node_w, 0.0),
        node_m2=gather(trees.node_m2, 0.0),
        node_to_move=gather(trees.node_to_move, 0),
        value0=gather(trees.value0, 0.0),
        size=torch.clamp(k, min=1).to(torch.int32),
    )
    return out, valid


def _pick(valid: torch.Tensor, a, b):
    """Per-game ``where(valid, a, b)`` over every tree field."""
    def sel(x, y):
        return torch.where(valid.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    kw = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "states":
            kw[f.name] = type(x)(**{
                k: sel(v, getattr(y, k)) for k, v in x.fields().items()})
        else:
            kw[f.name] = sel(x, y)
    return Tree(**kw)


def search_with_reuse(states: GoState, prev_trees: Tree,
                      prev_actions: torch.Tensor, predictor,
                      gen: torch.Generator, cfg: SearchConfig,
                      num_sims: int,
                      use_scoring: torch.Tensor | None = None,
                      budget: torch.Tensor | None = None,
                      fresh_mask: torch.Tensor | None = None,
                      adaptive: bool = False) -> Tree:
    """Search reusing each game's subtree under the move just played.

    With ``cfg.reuse_budget`` the reused subtree's visits count toward the
    per-move budget (`rollout_limit.rs:18-45`): the search tops up to
    ``num_sims`` root visits.  ``fresh_mask`` forces a fresh tree for games
    that were just replaced (continuous self-play).
    """
    capacity = prev_trees.node_n.shape[1]
    fresh = init_trees(states, predictor, gen, cfg, capacity, use_scoring)
    reused, valid = reroot(prev_trees, prev_actions, gen, cfg)
    if fresh_mask is not None:
        valid = valid & ~fresh_mask
    trees = _pick(valid, reused, fresh)
    if cfg.reuse_budget:
        prev_n = torch.clamp(trees.node_n[:, 0] - 1, min=0)
        base_budget = torch.full_like(prev_n, num_sims) if budget is None \
            else budget
        budget = torch.clamp(base_budget - prev_n, min=0)
    if adaptive:
        return run_search_adaptive(trees, predictor, cfg, num_sims,
                                   use_scoring, budget=budget)
    return run_search(trees, predictor, cfg, num_sims, use_scoring,
                      budget=budget)


# ---------------------------------------------------------------------------
# move selection and targets


def root_visits(trees: Tree) -> torch.Tensor:
    """i32[B, 362] visit counts of the root's children."""
    return trees.root_edge_n


def root_q(trees: Tree) -> torch.Tensor:
    """f32[B, 362] mean value of each root edge (root-perspective)."""
    n = trees.root_edge_n
    return torch.where(n > 0, trees.root_edge_w / torch.clamp(n, min=1),
                       trees.value0[:, :1])


def softmax_targets(trees: Tree) -> torch.Tensor:
    """Normalized root visit distribution (`tree.rs:1293-1306`)."""
    visits = root_visits(trees).float()
    return visits / torch.clamp(visits.sum(-1, keepdim=True), min=1.0)


def best_move(trees: Tree, gen: torch.Generator, cfg: SearchConfig,
              temperature: torch.Tensor):
    """(action[B], value[B]) — `tree.rs:1262-1282` best(): greedy LCB
    where ``temperature <= 0.09``, percentile-cutoff sampling otherwise."""
    visits = root_visits(trees)
    q = root_q(trees)
    count = visits.float()
    std = torch.sqrt(trees.node_m2.gather(
        1, torch.clamp(trees.root_child, min=0).long())
        / torch.clamp(count, min=1.0))
    z = cfg.critical_value.at(trees.node_n[:, 0].float())
    lcb = normal_lcb(q, std, torch.clamp(visits, min=1), z[:, None])

    eligible = visits >= MIN_LCB_VISITS
    greedy_score = torch.where(
        eligible.any(1, keepdim=True),
        torch.where(eligible, lcb, NEG_INF),
        _fma(torch.full_like(count, 1e-3), trees.prior[:, 0].float(),
             count))
    greedy_score = torch.where(visits > 0, greedy_score, NEG_INF)
    greedy_action = torch.where((visits > 0).any(1),
                                torch.argmax(greedy_score, 1), A - 1)
    sampled = choose(gen, count, cfg.cutoff_percentile,
                     float(cfg.temperature))
    action = torch.where(temperature <= 9e-2, greedy_action,
                         sampled).to(torch.int32)
    return action, q.gather(1, action[:, None].long())[:, 0]
