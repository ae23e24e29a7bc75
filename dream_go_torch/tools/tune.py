"""Black-box tuning of search hyperparameters by engine-against-engine
matches (port of `tools/tune.py`, which replaces the reference's CLOP
tuning through environment overrides): candidate values of ``--param``
play the baseline with a noisy uniform predictor, and the range narrows
around each candidate that wins more often than the best so far.

    python -m dream_go_torch.tools.tune --param UCT_EXP --lo 0.8 \\
        --hi 2.4 [--games 8] [--rounds 6] [--sims 32] [--max-moves 120] \\
        [--device cuda|cpu]

``--param`` is ``UCT_EXP`` or ``FPU_REDUCE`` (each a constant schedule).
``SOFTMAX_TEMPERATURE`` is refused: no module reads a search
configuration's softmax temperature (it scales the net's logits, and the
predictor has no logits here), so tuning it would move nothing.  A
match's games run in lockstep, one batch, each player's boards searched
together; ``--max-moves`` cuts them (the JAX tool's fixed cap is 120).
Prints a line a round on stderr and the best value on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..config import Schedule, SearchConfig
from ..go import benson, engine
from ..mcts import predictor as P
from ..mcts import search as S
from ..utils.device import resolve

PARAMS = {"UCT_EXP": "uct_exp", "FPU_REDUCE": "fpu_reduce"}
REFUSED = {"SOFTMAX_TEMPERATURE": (
    "SOFTMAX_TEMPERATURE tunes nothing: no module reads a search "
    "configuration's softmax temperature")}


def cfg_with(param: str, value: float, device) -> SearchConfig:
    name = param.upper()
    if name in REFUSED:
        raise ValueError(REFUSED[name])
    if name not in PARAMS:
        raise ValueError(f"unknown param {param}")
    return dataclasses.replace(
        SearchConfig(), **{PARAMS[name]: Schedule.constant(value)}
    ).resolve_auto(device)


def play_match(value_a, value_b, param, games, sims, seed, device="cuda",
               max_moves: int = 120) -> int:
    """Wins of A (``param=value_a``) against B (``value_b``) over
    ``games`` games, A black in the even ones."""
    device = torch.device(device)
    pred = P.random_predictor(
        noise=0.05, generator=torch.Generator(device=device).manual_seed(
            seed))
    cfgs = (cfg_with(param, value_a, device), cfg_with(param, value_b,
                                                       device))
    a_is_black = torch.arange(games, device=device) % 2 == 0
    states = engine.new_states(games, device=device)
    zero = torch.zeros(games, device=device)
    for mv_no in range(max_moves):
        black = states.to_move == engine.BLACK
        a_moves = black == a_is_black
        move = torch.full((games,), engine.PASS, dtype=torch.int32,
                          device=device)
        for side, rows in ((0, a_moves), (1, ~a_moves)):
            idx = rows.nonzero()[:, 0]
            if idx.numel() == 0:
                continue
            gen = torch.Generator(device=device).manual_seed(
                seed + 1000 * side + mv_no)
            trees = S.search(states.index(idx), pred, gen, cfgs[side], sims)
            mv, _ = S.best_move(trees, gen, cfgs[side], zero[idx])
            move[idx] = mv
        states = engine.step(states, move)
        if bool(states.done.all()):
            break
    final = benson.guess_score(states.stones, states.chain_id, states.komi)
    return int(((final > 0) == a_is_black).sum())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.tune")
    ap.add_argument("--param", default="UCT_EXP")
    ap.add_argument("--lo", type=float, default=0.8)
    ap.add_argument("--hi", type=float, default=2.4)
    ap.add_argument("--games", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sims", type=int, default=32)
    ap.add_argument("--baseline", type=float, default=None)
    ap.add_argument("--max-moves", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    name = args.param.upper()
    if name in REFUSED:
        ap.error(REFUSED[name])
    if name not in PARAMS:
        ap.error(f"--param must be one of {sorted(PARAMS)}")
    device = resolve(args.device)

    rng = np.random.default_rng(0)
    baseline = args.baseline if args.baseline is not None \
        else 0.5 * (args.lo + args.hi)
    lo, hi = args.lo, args.hi
    best, best_rate = baseline, 0.5
    for r in range(args.rounds):
        cand = float(rng.uniform(lo, hi))
        wins = play_match(cand, baseline, args.param, args.games, args.sims,
                          seed=r * 10_000, device=device,
                          max_moves=args.max_moves)
        rate = wins / args.games
        print(f"round {r}: {args.param}={cand:.3f} vs {baseline:.3f} "
              f"-> {wins}/{args.games} ({rate:.2f})", file=sys.stderr)
        if rate > best_rate:
            best, best_rate = cand, rate
            span = (hi - lo) * 0.7
            lo = max(args.lo, cand - span / 2)
            hi = min(args.hi, cand + span / 2)
    print(f"{args.param}={best:.4f} (winrate {best_rate:.2f} vs baseline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
