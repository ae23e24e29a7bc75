"""Search-tree introspection: a pretty root summary and an SGF export (port
of `dream_go_tpu/mcts/dump.py`).

``to_pretty`` is the candidate summary of a verbose genmove
(`tree.rs:1683-1731`); ``to_sgf`` writes a whole search tree as an SGF
variation tree, as the reference's ``trace-mcts`` feature does after every
move (`lib.rs:196-198`, `tree.rs:1147-1216`).  Both read one game
(``game``) of a batched :class:`~.search.Tree` on the host, and give the
JAX package's strings for equal trees.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import coords
from ..utils.lcb import normal_lcb
from . import search as S


def _tree_np(tree: S.Tree, game: int) -> dict:
    """Game ``game``'s tree as host numpy arrays, its two-tier edges
    (full-width root, sparse child slots) densified into one
    ``children[N, A]`` table."""
    row = lambda x: x[game].cpu().numpy()
    n = tree.node_n.shape[1]
    children = np.full((n, S.A), -1, np.int32)
    sa, sc = row(tree.slot_action), row(tree.slot_child)
    rows = np.repeat(np.arange(n), sa.shape[1])
    occ = sa.ravel() >= 0
    children[rows[occ], sa.ravel()[occ]] = sc.ravel()[occ]
    children[0] = row(tree.root_child)
    return dict(
        children=children,
        node_n=row(tree.node_n),
        node_w=row(tree.node_w),
        node_m2=row(tree.node_m2),
        prior=tree.prior[game].float().cpu().numpy(),
        to_move=row(tree.node_to_move),
    )


def _greedy_path(t, node, min_count=1, limit=12):
    path = []
    while len(path) < limit:
        children = t["children"][node]
        counts = np.where(children >= 0,
                          t["node_n"][np.maximum(children, 0)], 0)
        best = int(counts.argmax())
        if counts[best] < min_count:
            break
        path.append(best)
        node = int(children[best])
    return path


def to_pretty(tree: S.Tree, max_children: int = 10, game: int = 0) -> str:
    """One line for the root, then one a candidate: visits, mean win
    rate, LCB, prior and principal variation."""
    t = _tree_np(tree, game)
    root_n = int(t["node_n"][0])
    children = t["children"][0]
    safe = np.maximum(children, 0)
    counts = np.where(children >= 0, t["node_n"][safe], 0)
    means = np.where(
        children >= 0,
        1.0 - t["node_w"][safe] / np.maximum(t["node_n"][safe], 1), 0.0)
    win = float((counts * means).sum() / max(root_n, 1))
    pv = " ".join(coords.to_gtp(i) for i in _greedy_path(t, 0))
    lines = [f"Nodes: {root_n}, Win: {100.0 * win:.1f}%, PV: {pv}"]

    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    for i in np.argsort(-counts)[:max_children]:
        if counts[i] == 0:
            continue
        c = int(children[i])
        std = np.sqrt(t["node_m2"][c] / max(counts[i], 1))
        # float32, as the JAX package's jnp arithmetic computes it
        lcb = float(normal_lcb(f32(means[i]), f32(std),
                               torch.tensor(max(int(counts[i]), 1)), 1.0))
        sub_pv = " ".join(coords.to_gtp(j) for j in _greedy_path(t, c))
        lines.append(
            f"{coords.to_gtp(int(i)):>5} -> {int(counts[i]):7d} "
            f"(W: {100.0 * means[i]:5.2f}% / {100.0 * lcb:5.2f}%) "
            f"(N: {100.0 * t['prior'][0][i]:5.2f}%) "
            f"PV: {coords.to_gtp(int(i))} {sub_pv}")
    return "\n".join(lines)


def to_sgf(tree: S.Tree, komi: float = 7.5, meta: bool = True,
           min_visits: int = 1, game: int = 0) -> str:
    """The whole search tree as an SGF variation tree; every move carries
    ``C[visits / mean value]``."""
    t = _tree_np(tree, game)

    def color_of(node):
        return "B" if int(t["to_move"][node]) == 1 else "W"

    def emit(node):
        children = t["children"][node]
        kids = [(int(a), int(children[a])) for a in np.flatnonzero(
            children >= 0) if t["node_n"][children[a]] >= min_visits]
        branches = []
        for action, child in kids:
            n = int(t["node_n"][child])
            mean = 1.0 - t["node_w"][child] / max(n, 1)
            move = f";{color_of(node)}[{coords.to_sgf(action)}]" \
                f"C[{n} / {mean:.3f}]"
            branches.append(move + emit(child))
        if len(branches) == 1:
            return branches[0]
        return "".join(f"({b})" for b in branches)

    body = emit(0)
    if meta:
        return f"(;GM[1]FF[4]SZ[19]RU[Chinese]KM[{komi:.1f}]" \
            f"PL[{color_of(0)}]{body})"
    return body
