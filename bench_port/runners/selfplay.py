"""Continuous self-play through the program's main path.

Drives ``selfplay.search_play.search_self_play_continuous`` with the
mix's boards, rollouts and search settings, from starting positions drawn
by the seed out of recorded games.  One call is both set-up and window:
its first ``grow_sims`` simulations build the kernels, warm every shape
and grow the trees of the first move; the window opens at the next leaf
evaluation, so that it measures the search at the depths a 1600-rollout
move reaches, and the same call runs on.  The predictor it is handed
counts every batched evaluation and raises :class:`WindowClosed` at the
first call after the window's end, inside that move.

The check (after the window, from the window's own trees and from rows
of the window's batched evaluations captured on the way) replays each
sampled node's position with the plain rules of ``reference/go.py`` along
the actions of the tree's path, and holds the program to it:

- ``planes_diff``: captured leaf evaluations whose 32 input planes (the
  leaf kernel's output) differ from the reference's planes of that leaf;
- ``board_diff``: sampled nodes whose stones or side to move differ;
- ``mask_diff``: sampled nodes whose candidate moves differ (ScoringSearch
  on boards not yet scorable by Benson's life, else the legal moves);
- ``visit_diff``: broken visit counts: a root whose visits are not one
  plus the simulations run, or whose edges do not sum to them, and
  sampled nodes above the walk's depth bound whose incoming edge does not
  carry their visits;
- ``policy_gap_rel``: each captured policy's widest log-probability gap
  against the float32 reference tower's on the reference's planes (over
  entries the reference puts at 1e-6 or more), over the spread (standard
  deviation) of the reference's log-probabilities of that position; the
  widest over the captures;
- ``value_gap_sd``: the widest gap of a win rate (captured, or stored in
  the tree for a sampled node) from the reference's, over the spread of
  the reference's win rates over the checked positions (at least one
  bfloat16 step of a win rate).

Scaled so, the numbers do not swing with how far one seed's random heads
spread their outputs, which the unscaled gaps do.  Reported beside them,
not compared: ``policy_gap`` and ``value_gap`` unscaled,
``value_gap_rel`` (each value gap over that position's reference distance
from 0.5 or the median one), and ``prior_gap``, the tree's stored bf16
priors, masked and renormalised over the reference's candidates, as
log-gaps.  The control's numbers are read over the same
positions as the program's.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from .. import counts, games, harness, weights
from ..harness import checks
from ..profiling import Patches, StageTimers, Window, annotated, sync
from ..reference import go as ref_go
from ..reference import tower as ref_tower


#: the levels a walk records (dream-go's bound): a walk that reaches it
#: expands a new node in place of the child it would enter, and that
#: edge keeps the old child's counts, so edges below it are not held to
#: their nodes' visits
MAX_WALK = 128


#: one bfloat16 step of a win rate in [0.5, 1): the least spread of the
#: reference's values that ``value_gap_sd`` divides by, for a seed whose
#: value head gives every position nearly one value
WIN_RATE_STEP = 2.0 ** -8


class WindowClosed(Exception):
    """The window's time is up."""


class CountingPredictor:
    """The program's predictor, counting each batched evaluation; the
    window opens (``on_open``) at the first leaf evaluation after
    ``open_after`` of them, and the positions of the window's evaluations
    are counted.  Raises :class:`WindowClosed` at the first call at or
    after ``deadline``."""

    def __init__(self, inner, open_after: int):
        self.inner = inner
        self.open_after = open_after
        self.opened = False
        self.deadline = math.inf
        self.positions = 0
        self.leaf_calls = 0
        self.on_open = None      # hook() as the window opens
        self.on_leaf = None      # hook(call_index, x, value, policy)
        self.on_enter = None     # hook() at every call

    def _enter(self):
        if not self.opened and self.leaf_calls >= self.open_after:
            self.opened = True
            if self.on_open is not None:
                self.on_open()
        if self.on_enter is not None:
            self.on_enter()
        if time.perf_counter() >= self.deadline:
            raise WindowClosed

    def __call__(self, feats):
        self._enter()
        out = self.inner(feats)
        self.positions += feats.shape[0] if self.opened else 0
        return out

    def planes(self, x):
        self._enter()
        value, policy = self.inner.planes(x)
        self.leaf_calls += 1
        self.positions += x.shape[0] if self.opened else 0
        if self.on_leaf is not None:
            self.on_leaf(self.leaf_calls, x, value, policy)
        return value, policy


@dataclasses.dataclass
class State:
    predictor: CountingPredictor
    weights: dict
    states: object
    games: list
    pick: np.ndarray
    at: np.ndarray
    sp_cfg: object
    search_cfg: object
    batch: int
    trees: list
    captures: dict


def _configs(ctx):
    from dream_go_torch.config import ModelConfig, SearchConfig, \
        SelfPlayConfig

    cfg, tr = ctx.config, ctx.traffic
    model = ModelConfig(num_channels=cfg["num_channels"],
                        num_blocks=cfg["num_blocks"],
                        num_samples=cfg["num_samples"],
                        num_features=cfg["num_features"],
                        ladder_features=cfg["ladder_features"],
                        compute_dtype=cfg["compute_dtype"])
    search = SearchConfig(num_rollout=tr["num_rollout"],
                          dirichlet_noise=tr["dirichlet_noise"],
                          adaptive=tr["adaptive"], fused=tr["fused"],
                          ladder_features=cfg["ladder_features"])
    sp = SelfPlayConfig(num_games=10**9, num_rollout=tr["num_rollout"],
                        komi=tr["komi"], history_len=tr["history_len"],
                        winrate_rollouts=tr["winrate_rollouts"],
                        ladder_features=cfg["ladder_features"])
    return model, search.resolve_auto(ctx.device), sp


def setup(ctx) -> State:
    from dream_go_torch.mcts.predictor import NetPredictor
    from dream_go_torch.models import tower as T
    from dream_go_torch.selfplay import replay

    dev = torch.device(ctx.device)
    tr = ctx.traffic
    model_cfg, search_cfg, sp_cfg = _configs(ctx)
    recorded = [games.moves(line) for line in games.lines(tr["games"])]
    recorded = [g for g in recorded if g is not None]
    b = tr["boards"]
    pick, at = games.starting_positions(recorded, b, ctx.seed,
                                        tr["min_moves"])
    moves = torch.as_tensor(games.padded(recorded, pick, at), device=dev)
    states = replay.states_at(
        moves, torch.as_tensor(at, dtype=torch.int32, device=dev),
        torch.full((b,), tr["komi"], dtype=torch.float32, device=dev),
        tr["history_len"])

    dtype = getattr(torch, ctx.config["compute_dtype"])
    w = weights.make(weights.dg_shapes(ctx.config, train=False), ctx.seed,
                     dev, dtype)
    model = T.Tower(model_cfg)
    model.load_state_dict(w)
    model = T.place(model, model_cfg, dev)
    predictor = CountingPredictor(NetPredictor(model), tr["grow_sims"])
    return State(predictor, w, states, recorded, pick, at, sp_cfg,
                 search_cfg, b, [], {})


def _play(state: State, ctx) -> None:
    """The program's continuous self-play until the predictor closes the
    window; the trees it allocates are kept in ``state.trees``."""
    from dream_go_torch.mcts import search as S
    from dream_go_torch.selfplay import search_play as SP

    init = S.init_trees

    def keep(*args, **kwargs):
        trees = init(*args, **kwargs)
        state.trees.append(trees)
        return trees

    with Patches() as p:
        p.set(S, "init_trees", keep)
        try:
            SP.search_self_play_continuous(
                state.predictor, state.sp_cfg, state.search_cfg,
                seed=ctx.seed, batch=state.batch, refill_every=8,
                device=ctx.device, initial_states=state.states)
        except WindowClosed:
            pass


def _capture_hook(state: State, ctx):
    """Rows of chosen leaf evaluations, with each row's tree size before
    that evaluation's insert and before the next one's.  The copies to
    the host are queued without waiting, so the window keeps its overlap
    of the tower with the host's next select; they are read after the
    window's closing synchronisation."""
    tr = ctx.traffic["check"]
    rng = np.random.default_rng(ctx.seed ^ 0x5EED)
    rows = np.sort(rng.choice(state.batch, min(tr["capture_rows"],
                                               state.batch), replace=False))
    rows_t = torch.as_tensor(rows, device=ctx.device)
    at = {state.predictor.open_after + k for k in tr["capture_after"]}
    caps = state.captures

    def host(t):
        return t[rows_t].to("cpu", non_blocking=True)

    def hook(k, x, value, policy):
        if not state.trees or (k not in at and k - 1 not in caps):
            return
        size = host(state.trees[-1].size)
        if k - 1 in caps:
            caps[k - 1]["size_next"] = size
        if k in at:
            caps[k] = {"rows": rows, "size": size, "planes": host(x),
                       "value": host(value), "policy": host(policy)}

    return hook


def window(state: State, ctx) -> dict:
    """The program's continuous self-play: its first ``grow_sims``
    simulations grow the trees in set-up, the window opens at the next
    leaf evaluation and the same search runs on until its time is up."""
    from dream_go_torch.mcts import search as S
    from dream_go_torch.selfplay import search_play as SP

    pred = state.predictor
    pred.on_leaf = _capture_hook(state, ctx)
    record = {"trace": ctx.trace, "flops_per_position":
              counts.dg_config_flops(ctx.config)}
    timers = StageTimers()
    prof = Window() if ctx.trace else None
    k1 = {"boards": []}
    levels = []
    opened = {}

    def on_open():
        sync()
        t0 = time.perf_counter()
        opened["t0"] = t0
        pred.deadline = t0 + ctx.seconds
        opened["trace_at"] = pred.deadline - min(
            ctx.seconds, ctx.traffic["trace_seconds"])
        timers.table.clear()
        levels.clear()

    pred.on_open = on_open
    with Patches() as p:
        if ctx.trace:
            select = timers.wrap("select", S._select_flat)

            def select_levels(*a, **kw):
                out = select(*a, **kw)
                levels.append(float((out[3] >= 0).sum(1).float().mean()))
                return out

            p.set(S, "_select_flat", select_levels)
            leaf = S.leaf_step

            def leaf_step(*a, **kw):
                if prof.t0 is not None and prof.t1 is None:
                    k1["boards"].append(int(a[0].shape[0]))
                with torch.profiler.record_function("leaf_step"):
                    return leaf(*a, **kw)

            p.set(S, "leaf_step", leaf_step)
            for mod, attr, name in ((S, "_insert_backup_flat",
                                     "insert + backup"),
                                    (S, "scoring_mask", "scoring mask"),
                                    (S, "init_trees", "root evaluation"),
                                    (SP, "_finish_move", "finish move")):
                p.set(mod, attr, annotated(name, getattr(mod, attr)))
            p.set(pred, "inner", _AnnotatedNet(pred.inner))

            def maybe_start():
                if pred.opened and prof.t0 is None \
                        and time.perf_counter() >= opened["trace_at"]:
                    prof.start()

            pred.on_enter = maybe_start
        _play(state, ctx)
        sync()
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
    pred.on_leaf = pred.on_enter = pred.on_open = None
    if "t0" not in opened:
        raise RuntimeError("the search ended before the window opened")
    t0 = opened["t0"]
    record.update(opened_at=t0, window_s=t1 - t0, positions=pred.positions,
                  leaf_calls=pred.leaf_calls, boards=state.batch,
                  attempted=pred.positions, failed=0)
    if ctx.trace:
        record.update(select_s=timers.seconds("select"),
                      select_levels=(sum(levels) / len(levels)
                                     if levels else None),
                      profile=prof.summary(),
                      k1_bytes=sum(counts.leaf_step_bytes(b)
                                   for b in k1["boards"]))
    return record


class _AnnotatedNet:
    """The tower's evaluations inside a profiler span named ``net``."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, feats):
        with torch.profiler.record_function("net"):
            return self.inner(feats)

    def planes(self, x):
        with torch.profiler.record_function("net"):
            return self.inner.planes(x)


# ---------------------------------------------------------------------------
# the check


def _path(parent, action, node) -> list[int]:
    acts = []
    while node > 0:
        acts.append(int(action[node]))
        node = int(parent[node])
    return acts[::-1]


def _depth(parent, size) -> np.ndarray:
    depth = np.zeros(size, np.int64)
    for n in range(1, size):
        depth[n] = depth[parent[n]] + 1
    return depth


def _tree_rows(trees, boards) -> dict:
    """Host copies of the sampled boards' trees."""
    st = trees.states
    fields = {
        "size": trees.size, "parent": trees.parent,
        "parent_action": trees.parent_action, "node_n": trees.node_n,
        "root_edge_n": trees.root_edge_n, "root_child": trees.root_child,
        "slot_child": trees.slot_child, "slot_n": trees.slot_n,
        "value0": trees.value0, "cand": trees.cand, "prior": trees.prior,
        "stones": st.stones,
        "to_move": st.meta if hasattr(st, "meta") else st.to_move,
    }
    idx = torch.as_tensor(boards, device=trees.size.device)
    out = {k: v[idx] for k, v in fields.items()}
    out["prior"] = out["prior"].float()
    out["stones"] = out["stones"][..., :ref_go.NN]
    if hasattr(st, "meta"):
        out["to_move"] = out["to_move"][..., 0]
    return {k: v.cpu().numpy() for k, v in out.items()}


def _unpack(words: np.ndarray) -> np.ndarray:
    bits = (words.astype(np.int64)[:, None] >> np.arange(32)) & 1
    return bits.reshape(-1)[:362].astype(bool)


def check(state: State, ctx, record) -> list[Check]:
    tr = ctx.traffic["check"]
    limits = ctx.traffic["limits"]
    if len(state.trees) != 1:
        raise RuntimeError("the window must end inside the first move: "
                           f"{len(state.trees)} searches were started")
    trees = state.trees[-1]
    sims = state.predictor.leaf_calls
    rng = np.random.default_rng(ctx.seed ^ 0xC4EC)
    cap_boards = set()
    for cap in state.captures.values():
        cap_boards.update(int(r) for r in cap["rows"])
    sample = rng.choice(state.batch, min(tr["sample_boards"], state.batch),
                        replace=False)
    boards = sorted(set(int(b) for b in sample) | cap_boards)
    rows = _tree_rows(trees, boards)
    at_board = {b: i for i, b in enumerate(boards)}
    # the program's state is freed before the reference runs
    state.trees.clear()
    del trees
    state.states = None
    gc.collect()
    torch.cuda.empty_cache() if ctx.device == "cuda" else None

    # nodes to check: per sampled board a few drawn nodes and the deepest;
    # per captured evaluation the node its leaf became
    nodes = {}   # (board, node) -> captured (planes, value, policy) or None
    visit_diff = 0
    for b in sample:
        i = at_board[int(b)]
        size = int(rows["size"][i])
        n_root = int(rows["node_n"][i][0])
        visit_diff += int(n_root - 1 != sims)
        visit_diff += int(int(rows["root_edge_n"][i].sum()) != sims)
        if size > 1:
            depth = _depth(rows["parent"][i], size)
            for n in rng.integers(1, size, tr["nodes_per_board"]):
                nodes[(int(b), int(n))] = None
            nodes[(int(b), int(np.argmax(depth)))] = None
    for cap in state.captures.values():
        if "size_next" not in cap:
            continue
        size, size_next = cap["size"].numpy(), cap["size_next"].numpy()
        for j, b in enumerate(cap["rows"]):
            if size_next[j] > size[j]:
                nodes[(int(b), int(size[j]))] = (
                    cap["planes"][j].float(), cap["value"][j].float(),
                    cap["policy"][j].float())

    roots = {}
    keys, planes, masks = [], [], []
    board_diff = mask_diff = planes_diff = deepest = 0
    for (b, n), cap in nodes.items():
        i = at_board[b]
        if b not in roots:
            root = ref_go.replay(state.games[state.pick[b]][:state.at[b]],
                                 ctx.traffic["komi"],
                                 ctx.traffic["history_len"])
            scoring = not root.done and not ref_go.is_scorable(root)
            roots[b] = (root, scoring)
        root, scoring = roots[b]
        board = root.copy()
        path = _path(rows["parent"][i], rows["parent_action"][i], n)
        deepest = max(deepest, len(path))
        try:
            for a in path:
                board.play(a)
        except ValueError:  # the tree's path is not legal on its board
            board_diff += 1
            continue
        ana = board.analysis()
        p = ref_go.v1_planes(board, ana)
        mask = (ref_go.scoring_mask(board, ana) if scoring
                else ref_go.standard_mask(board, ana))
        board_diff += int(
            not np.array_equal(rows["stones"][i][n], board.stones)
            or int(rows["to_move"][i][n]) != board.to_move)
        mask_diff += int(not np.array_equal(_unpack(rows["cand"][i][n]),
                                            mask))
        parent = int(rows["parent"][i][n])
        if parent == 0:
            a = int(rows["parent_action"][i][n])
            edge = int(rows["root_edge_n"][i][a])
            visit_diff += int(int(rows["root_child"][i][a]) != n)
        else:
            slot = np.flatnonzero(rows["slot_child"][i][parent] == n)
            edge = int(rows["slot_n"][i][parent][slot[0]]) if len(slot) \
                else -1
        if len(path) < MAX_WALK:
            visit_diff += int(edge != int(rows["node_n"][i][n]))
        x = torch.as_tensor(p.T.reshape(32, 19, 19).copy())
        if cap is not None:
            planes_diff += int(not torch.equal(cap[0].reshape(32, 19, 19),
                                               x))
        keys.append((b, n, cap))
        planes.append(x)
        masks.append(mask)

    x = torch.stack(planes).to(ctx.device)
    blocks = ctx.config["num_blocks"]
    w32 = {k: v.float() for k, v in state.weights.items()}
    with ref_tower.float32():
        value_ref, policy_ref = ref_tower.predict(w32, x, blocks)
        if ctx.control:
            value_low, policy_low = ref_tower.predict(w32, x, blocks,
                                                      ref_tower.fp8)
    value_ref, policy_ref = value_ref.cpu().numpy(), policy_ref.cpu().numpy()
    prog = _gaps(keys, masks, value_ref, policy_ref, rows, at_board)
    if ctx.control:
        record["control"] = _gaps(keys, masks, value_ref, policy_ref, rows,
                                  at_board, value_low.cpu().numpy(),
                                  policy_low.cpu().numpy())
    record["checked_nodes"] = len(keys)
    record["deepest_checked"] = deepest
    counted = {"planes_diff": planes_diff, "board_diff": board_diff,
               "mask_diff": mask_diff, "visit_diff": visit_diff, **prog}
    return checks(counted, limits, record)


def _log_gap(p, q, keep) -> float:
    if not keep.any():
        return 0.0
    return float(np.abs(np.log(np.maximum(p[keep], 1e-30))
                        - np.log(q[keep])).max())


def _widest(values) -> float:
    """The largest of ``values`` (0 for none); NaN where any is NaN, so
    that a run computing NaN fails its check."""
    return float(np.max(values)) if len(values) else 0.0


def _gaps(keys, masks, value_ref, policy_ref, rows, at_board,
          value_low=None, policy_low=None) -> dict:
    """The widest value, policy and prior gaps against the reference: of
    the program's numbers, or (``value_low``, ``policy_low``) of the
    float8 reference put in the program's place.  ``value_gap_sd`` is the
    widest value gap over the spread of the reference's values over the
    checked positions, and ``policy_gap_rel`` each captured policy's
    widest log-gap over the spread of the reference's log-probabilities of
    that position: both scale out how far one seed's random heads spread
    their outputs."""
    value_gaps, value_rels, policy_gaps, policy_rels, prior_gaps = \
        [], [], [], [], []
    size = np.abs(value_ref - 0.5)
    med = max(float(np.median(size)), 1e-12)
    for j, (b, n, cap) in enumerate(keys):
        i = at_board[b]
        mask = masks[j]
        q = policy_ref[j] * mask
        q = q / max(q.sum(), 1e-12)
        if value_low is not None:
            # in the program's place: over the same positions as its own
            raw = policy_low[j]
            v_tree = float(value_low[j])
            prior = torch.as_tensor(raw * mask / max((raw * mask).sum(),
                                                     1e-12))
            prior = prior.to(torch.bfloat16).float().numpy()  # as stored
            v_cap, pol = (v_tree, raw) if cap is not None else (None, None)
        else:
            v_tree = float(rows["value0"][i][n])
            prior = rows["prior"][i][n]
            v_cap, pol = ((float(cap[1]), cap[2].numpy()) if cap is not None
                          else (None, None))
        gaps = [abs(v_tree - float(value_ref[j]))]
        prior_gaps.append(_log_gap(prior, q, mask & (q >= 1e-6)))
        if v_cap is not None:
            gaps.append(abs(v_cap - float(value_ref[j])))
            keep = policy_ref[j] >= 1e-6
            gap = _log_gap(pol, policy_ref[j], keep)
            policy_gaps.append(gap)
            spread = float(np.log(policy_ref[j][keep]).std()) \
                if keep.sum() > 1 else 0.0
            policy_rels.append(gap / max(spread, 1e-12))
        value_gaps.append(_widest(gaps))
        value_rels.append(value_gaps[-1] / max(float(size[j]), med))
    value_gap = _widest(value_gaps)
    return {"value_gap": value_gap, "value_gap_rel": _widest(value_rels),
            "value_gap_sd": value_gap / max(float(value_ref.std()),
                                            WIN_RATE_STEP),
            "policy_gap": _widest(policy_gaps),
            "policy_gap_rel": _widest(policy_rels),
            "prior_gap": _widest(prior_gaps)}
