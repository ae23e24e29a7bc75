"""Where the self-play time goes on the card.

    python -m dream_go_torch.trace [--games 256] [--rollouts 64] \\
        [--moves 3] [--profile-sims 8]

Runs the CLI's continuous self-play (by default at the full 128 x 9
width, seeded random weights) for a few batch moves and prints two
breakdowns:

1. host wall time per search stage (root evaluation, Benson scorability,
   select, leaf_step, ScoringSearch masks, network, backup, re-rooting,
   move choice), each stage timed between two ``torch.cuda.synchronize()``
   calls.  Stages nest where one calls another: the root evaluation
   includes its own network call and masks, and "network" and "scoring
   mask" count both the roots' and the leaves' calls.  Also the number of
   tree levels each select walks (the deepest game of the batch);
2. a ``torch.profiler`` window over ``--profile-sims`` simulations: device
   time by kernel, and the device's busy and idle share of the window.

Timing with synchronisation slows the run down; the stage shares are what
it is for, not the absolute rate.  The card's name and power limit are
printed beside the numbers.  ``--device cpu`` only rehearses the script.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import time

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(table, name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        table[name][0] += time.perf_counter() - t0
        table[name][1] += 1
        return out

    return wrapper


def stage_breakdown(args) -> dict:
    """Self-play with every search stage wrapped in a synchronised timer."""
    from . import cli
    from .go import benson
    from .mcts import search as S
    from .selfplay import search_play as SP

    table = collections.defaultdict(lambda: [0.0, 0])
    patches = [
        (S, "init_trees", "root eval (init_trees)"),
        (S, "_select_flat", "select"),
        (S, "leaf_step", "leaf_step (kernel)"),
        (S, "scoring_mask", "scoring mask (leaves + roots)"),
        (S, "_insert_backup_flat", "insert + backup"),
        (S, "reroot", "reroot"),
        (SP, "_finish_move", "best move + board step"),
    ]
    saved = []
    for mod, attr, name in patches:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _timed(table, name, getattr(mod, attr)))
    depths = []
    timed_select = S._select_flat

    def select_with_depth(*a, **kw):
        out = timed_select(*a, **kw)
        depths.append(int((out[3] >= 0).sum(1).max()))  # deepest game
        return out

    S._select_flat = select_with_depth
    SP.bn = _Proxy(benson, is_scorable=_timed(
        table, "is_scorable (roots)", benson.is_scorable))
    try:
        cli_args = cli.build_parser().parse_args([
            "--self-play", str(args.games), "--continuous", "--num-rollout",
            str(args.rollouts), "--num-games", str(args.games),
            "--max-moves", str(args.moves), "--seed", "0",
            "--num-channels", str(args.channels),
            "--num-blocks", str(args.blocks)])
        predictor = cli.load_predictor(cli_args, args.device)
        predictor.planes = _timed(table, "network", predictor.planes)
        cfg = cli.search_config(cli_args, args.device)
        from .config import SelfPlayConfig

        _sync()
        t0 = time.perf_counter()
        games = SP.search_self_play_continuous(
            predictor, SelfPlayConfig(num_games=args.games,
                                      num_rollout=args.rollouts,
                                      max_moves=args.moves),
            cfg, seed=0, batch=args.games, refill_every=args.moves,
            device=args.device)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        SP.bn = benson
    return {"wall_s": wall, "games": len(games),
            "select_levels": {"mean": sum(depths) / max(len(depths), 1),
                              "max": max(depths, default=0)},
            "stages": {k: {"s": v[0], "calls": v[1]}
                       for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1][0])}}


class _Proxy:
    """A module stand-in with some attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over.get(name, getattr(self._mod, name))


def profile_window(args) -> dict:
    """torch.profiler over a few lockstep simulations of one search."""
    from torch.profiler import ProfilerActivity, profile

    from . import cli
    from .go import benson, engine
    from .mcts import search as S

    cli_args = cli.build_parser().parse_args([
        "--self-play", str(args.games), "--continuous", "--num-rollout",
        str(args.rollouts), "--num-games", str(args.games),
        "--num-channels", str(args.channels), "--num-blocks", str(args.blocks)])
    dev = args.device
    predictor = cli.load_predictor(cli_args, dev)
    cfg = cli.search_config(cli_args, dev)
    states = engine.new_states(args.games, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    use_scoring = ~benson.is_scorable(states) & ~states.done
    trees = S.init_trees(states, predictor, gen, cfg, args.rollouts + 8,
                         use_scoring)
    trees = S.run_search(trees, predictor, cfg, 8, use_scoring)  # warm-up
    _sync()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trees = S.run_search(trees, predictor, cfg, args.profile_sims,
                             use_scoring)
        _sync()
    wall = time.perf_counter() - t0
    kernels = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += evt.self_device_time_total
    busy_us = sum(kernels.values())
    top = [{"kernel": k[:90], "ms": v / 1e3}
           for k, v in kernels.most_common(12)]
    return {"sims": args.profile_sims, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
            "top_kernels": top}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dream_go_torch.trace")
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--rollouts", type=int, default=64)
    parser.add_argument("--moves", type=int, default=3)
    parser.add_argument("--profile-sims", type=int, default=8)
    parser.add_argument("--channels", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=9)
    parser.add_argument("--device", type=torch.device, default="cuda",
                        help="cpu only rehearses the script: its times "
                             "are not device times")
    args = parser.parse_args(argv)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dream_go_torch.trace: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"stage_breakdown": stage_breakdown(args)}), flush=True)
    print(json.dumps({"profile": profile_window(args)}), flush=True)


if __name__ == "__main__":
    main()
