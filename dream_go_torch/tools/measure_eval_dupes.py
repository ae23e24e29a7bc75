"""Repeated leaf evaluations in the lockstep search (port of
`tools/measure_eval_dupes.py`).

The reference keeps an LRU cache in front of the net to dedupe
transposition evaluations.  The batched array search expands a new node
at each simulation, so the only repeats are transpositions reached
through different move orders.  This counts them: it plays ``--moves``
uniformly random opening moves on ``--games`` boards, builds the trees
(`mcts/search.py::init_trees`) and runs ``run_search`` one simulation at
a time, and reports the share of leaf evaluations whose board (hash and
player to move) the same game already evaluated in this search (the only
case the reference's cache would serve).  The fused search (K1 on the
card) with Dirichlet noise, a seeded random 16 x 2 net.

    python -m dream_go_torch.tools.measure_eval_dupes [--games 64] \\
        [--sims 96] [--moves 12] [--device cuda|cpu]

Prints the JAX tool's line, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import SearchConfig
from ..mcts import search as S
from ..utils.device import describe, resolve
from .common import load_net, opening


def leaf_keys(trees: S.Tree) -> np.ndarray:
    """int64[B, C, 3]: each node's hash words and player to move."""
    st = trees.states
    if isinstance(st, S.PackedStates):
        hashw, to_move = st.hashw, st.meta[..., 0]
    else:
        hashw, to_move = st.hash, st.to_move
    return torch.cat([hashw.long(), to_move.long()[..., None]],
                     -1).cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dream_go_torch.tools.measure_eval_dupes")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--sims", type=int, default=96)
    ap.add_argument("--moves", type=int, default=12)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    cfg = SearchConfig(dirichlet_noise=0.25, fused=True, adaptive=False)
    pred, _ = load_net(None, args.channels, args.blocks, device)

    b = args.games
    gen = torch.Generator(device=device).manual_seed(args.seed)
    states = opening(b, args.moves, gen, device)

    trees = S.init_trees(states, pred, gen, cfg, args.sims + 1, None)
    total = dupes = 0
    seen = [set() for _ in range(b)]
    for _ in range(args.sims):
        trees = S.run_search(trees, pred, cfg, 1, None)
        # the leaf a simulation inserts is each game's node size - 1
        sizes = trees.size.cpu().numpy()
        keys = leaf_keys(trees)
        for g in range(b):
            h = tuple(int(x) for x in keys[g, sizes[g] - 1])
            total += 1
            if h in seen[g]:
                dupes += 1
            seen[g].add(h)

    print(f"leaf evaluations: {total}; repeated board hashes "
          f"(would-be cache hits): {dupes} "
          f"({100.0 * dupes / max(total, 1):.2f}%)")
    print(json.dumps({"leaf_evaluations": total, "repeats": dupes,
                      "repeat_pct": 100.0 * dupes / max(total, 1),
                      "games": b, "sims": args.sims, "moves": args.moves,
                      "device": describe(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
