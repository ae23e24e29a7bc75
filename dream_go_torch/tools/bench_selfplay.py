"""Sustained full-search self-play throughput, games/s and simulations/s
(port of `tools/bench_selfplay.py`).

The reference's headline self-play rate is ~0.02 games/s at 1600
rollouts a move on its GPU setup.  This measures
`search_self_play_continuous`, which keeps the batch full of live games,
so the rate is the steady production rate, not one lockstep batch with a
long idle tail.

Protocol: a warm-up run (one batch move at the same batch, cut to 16
rollouts: the kernels build and cuDNN picks its algorithms), then the
timed run, wall to wall.  Simulation counts come from the games' ``TV[n]``
annotations (the simulations charged to each recorded move), so sims/s is
a lower bound (moves of games unfinished at the end are not counted).
``games_per_sec_steady`` is the completion rate after the first
``--warmup-games`` games (the batch's ramp).

    python -m dream_go_torch.tools.bench_selfplay [--weights W.json] \\
        [--channels 128 --blocks 9] [--batch 1024] [--rollout 1600] \\
        [--games 64] [--warmup-games 4] [--device cuda|cpu]

Planes 30/31 follow the net's contract unless ``--ladder-features`` /
``--no-ladder-features`` say otherwise.  Prints one JSON line, the JAX
tool's keys with the device's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

from ..config import SearchConfig, SelfPlayConfig
from ..selfplay.search_play import search_self_play_continuous
from ..utils.device import describe, resolve, sync
from .common import add_ladder_flags, load_net

_TV_RE = re.compile(r"TV\[(\d+)\]")
#: the warm-up run's rollouts
WARMUP_ROLLOUTS = 16


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.bench_selfplay")
    ap.add_argument("--weights")
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rollout", type=int, default=1600)
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--warmup-games", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=0,
                    help="tree node cap (0: rollout + 8)")
    ap.add_argument("--max-moves", type=int, default=None,
                    help="cut every game at this many moves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="stop after this many wall seconds even if fewer "
                         "games completed (fixed-window mode)")
    add_ladder_flags(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    predictor, cfg = load_net(args.weights, args.channels, args.blocks,
                              device)
    ladders = cfg.ladder_features if args.ladder_features is None \
        else args.ladder_features
    sc = SearchConfig(num_rollout=args.rollout, max_nodes=args.capacity,
                      ladder_features=ladders).resolve_auto(device)
    extra = {} if args.max_moves is None else {"max_moves": args.max_moves}

    warm = SelfPlayConfig(num_games=1, num_rollout=min(WARMUP_ROLLOUTS,
                                                       args.rollout), **extra)
    search_self_play_continuous(predictor, warm, sc, seed=args.seed + 1,
                                batch=args.batch, device=device,
                                deadline_s=0.0)
    sync(device)

    total = args.warmup_games + args.games
    sp = SelfPlayConfig(num_games=total, num_rollout=args.rollout, **extra)
    game_times: list = []
    t0 = time.monotonic()
    games = search_self_play_continuous(predictor, sp, sc, seed=args.seed,
                                        batch=args.batch, device=device,
                                        game_times=game_times,
                                        deadline_s=args.deadline)
    sync(device)
    dt = time.monotonic() - t0

    sims = sum(int(m) for g in games for m in _TV_RE.findall(g))
    moves = sum(len(_TV_RE.findall(g)) for g in games)
    steady = None
    if len(game_times) > args.warmup_games + 1:
        window = game_times[args.warmup_games:]
        span = window[-1] - window[0]
        if span > 0:
            steady = (len(window) - 1) / span
    print(json.dumps({
        "games": len(games), "seconds": round(dt, 1),
        "games_per_sec_wall": round(len(games) / dt, 4),
        "games_per_sec_steady": round(steady, 4) if steady else None,
        "ramp_games": args.warmup_games,
        "moves": moves, "sims": sims,
        "sims_per_sec_wall": round(sims / dt, 1),
        "batch": args.batch, "rollout": args.rollout,
        "net": args.weights or f"{args.channels}x{args.blocks}-random",
        "ladder_features": bool(ladders),
        "device": describe(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
