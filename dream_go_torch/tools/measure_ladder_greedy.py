"""Greedy-against-exact ladder agreement over random positions (port of
`tools/measure_ladder_greedy.py`).

The exact reader explores the reference's full branch recursion
(`ladder.rs:110-119`): the ladder kernel (K2) on the card, its plain
version on the CPU; the greedy reader (`go/ladder.py`, ``greedy=True``)
chases only the tight branch.  Both read every candidate of every board
(the JAX tool bounds both to 32), and the agreement is counted at the
candidate points (`go/ladder.py::candidates`, the prefilter of
``ladder_planes``), over uniformly random playouts (default; a dense
torture distribution) or positions sampled from games (``--sgf FILE...``,
the distribution the feature planes see):

    python -m dream_go_torch.tools.measure_ladder_greedy --points 50000
    python -m dream_go_torch.tools.measure_ladder_greedy \\
        --sgf tests/fixtures/sample_games.sgf [--device cuda|cpu]

Prints the JAX tool's lines, then one JSON line of the totals.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..go import engine, ladder
from ..ops import layout
from ..ops.ladder_kernel import ladder_planes_kernel
from ..selfplay.replay import states_at
from ..train.pipeline import parse_game
from ..utils.device import describe, resolve
from .common import random_playout


def both_readers(states: engine.GoState):
    """``(exact capture, exact escape, greedy capture, greedy escape)``."""
    stones, cid = layout.board_rows(states)
    ce, ee = ladder_planes_kernel(stones, cid, states.to_move.to(torch.int32))
    cg, eg = ladder.ladder_planes(states, max_candidates=None,
                                  max_escapes=None, greedy=True)
    return ce, ee, cg, eg


def sgf_position_batches(paths, batch, per_game, seed, device):
    """Batches of states sampled from the games of these big-SGF files
    (``per_game`` positions a game, past its tenth move)."""
    games = []
    for path in paths:
        with open(path) as fh:
            games.extend(g for g in (parse_game(l) for l in fh if l.strip())
                         if g is not None and len(g.moves) >= 30)
    rng = np.random.default_rng(seed)
    samples = []  # (game_idx, position)
    for gi, g in enumerate(games):
        n = len(g.moves)
        for pos in rng.choice(n - 10, size=min(per_game, n - 10),
                              replace=False):
            samples.append((gi, 10 + int(pos)))  # skip the empty opening
    rng.shuffle(samples)
    t_max = max(len(g.moves) for g in games)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    for start in range(0, len(samples) - batch + 1, batch):
        chunk = samples[start:start + batch]
        moves = np.full((batch, t_max), engine.PASS, np.int32)
        tgt = np.zeros(batch, np.int32)
        komi = np.zeros(batch, np.float32)
        for row, (gi, pos) in enumerate(chunk):
            seq = games[gi].moves
            moves[row, :len(seq)] = seq
            tgt[row] = pos
            komi[row] = games[gi].komi
        yield states_at(t(moves), t(tgt), t(komi), 64)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dream_go_torch.tools.measure_ladder_greedy")
    ap.add_argument("--points", type=int, default=50000,
                    help="minimum candidate points to evaluate")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[40, 80, 120, 160, 200])
    ap.add_argument("--sgf", nargs="+",
                    help="measure over positions sampled from these SGF "
                         "files instead of random playouts")
    ap.add_argument("--per-game", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    total = agree = 0
    disagreements = []

    def tally(st, tag, where):
        nonlocal total, agree
        cap_c, esc_c = ladder.candidates(st)
        ce, ee, cg, eg = both_readers(st)
        cap_c, esc_c, ce, ee, cg, eg = (
            x.cpu().numpy() for x in (cap_c, esc_c, ce, ee, cg, eg))
        cand = cap_c | esc_c
        n = int(cand.sum())
        ok = int(((ce == cg) & (ee == eg) & cand).sum())
        total += n
        agree += ok
        if ok != n:
            bad = np.argwhere(((ce != cg) | (ee != eg)) & cand)
            disagreements.extend(
                (tag, where, int(b), int(p)) for b, p in bad[:8])
        print(f"{tag} {where}: {ok}/{n} agree "
              f"(cum {agree}/{total} = {agree / max(total, 1):.5f})",
              flush=True)

    if args.sgf:
        for i, st in enumerate(sgf_position_batches(
                args.sgf, args.batch, args.per_game, args.seed, device)):
            tally(st, "sgf-batch", i)
            if total >= args.points:
                break
    else:
        seed = args.seed
        while total < args.points:
            gen = torch.Generator(device=device).manual_seed(seed)
            st = engine.new_states(args.batch, device=device)
            depth = 0
            for d in args.depths:
                st = random_playout(st, d - depth, gen)
                depth = d
                tally(st, seed, d)
            seed += 1

    rate = agree / max(total, 1)
    print(f"\nagreement: {agree}/{total} = {rate:.5%}")
    if disagreements:
        print("sample disagreements (seed, depth, board, point):")
        for d in disagreements[:20]:
            print(" ", d)
    print("PASS (>=99.9%)" if rate >= 0.999 else "FAIL (<99.9%)")
    print(json.dumps({"points": total, "agree": agree, "rate": rate,
                      "device": describe(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
