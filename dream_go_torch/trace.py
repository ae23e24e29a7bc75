"""Where the self-play (or training) time goes on the card.

    python -m dream_go_torch.trace [--games 256] [--rollouts 64] \\
        [--moves 3] [--profile-sims 8] [--ladder-features] \\
        [--no-fused] [--feature-kernel]
    python -m dream_go_torch.trace --train [--train-steps 5] \\
        [--batch-size 2048] [--bank-games 1024] [--train-data FILE]

Runs the CLI's continuous self-play (by default at the full 128 x 9
width, seeded random weights) for a few batch moves and prints two
breakdowns:

1. the program's span table (`utils/spans.py`), recorded under
   ``spans.recording()``: each span's calls, total and self seconds
   (self: less its direct children), by self seconds, and the counters.
   The spans take the host's clock without synchronising, so a stage's
   time is what the host spent in it: launching its work, or waiting for
   the device in the ``*.wait`` spans (``search.select.wait``,
   ``selfplay.move.wait``).  ``search.select.board_levels`` over
   ``search.select.lane_trips`` is the share of the lockstep walk's
   board-levels that advanced a board (on a card, where the walk is one
   kernel launch, ``lane_trips`` counts the levels the plain loop would
   have run); ``search.select.launches`` against ``search.simulations``
   shows that every simulation walked its trees with the kernel;
2. a ``torch.profiler`` window over ``--profile-sims`` simulations: device
   time by kernel, the device's busy and idle share of the window, and
   the window's span table.

With ``--train`` it profiles ``--train-steps`` steps of the trainer
instead (`train/train_loop.py::Trainer.fit`, 128 x 9 bf16, batches of
``--batch-size`` from a bank of ``--bank-games`` games of ``--train-data``,
8 positions each, after three steps of warm-up that build the bank): the
milliseconds a step, device time by kernel, the idle share and the
window's span table (``train.*``, ``pipeline.batch``).

The card's name and power limit are printed beside the numbers.
``--device cpu`` only rehearses the script.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from .utils import spans


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _cli_args(args, extra=()):
    from . import cli

    argv = ["--self-play", str(args.games), "--continuous", "--num-rollout",
            str(args.rollouts), "--num-games", str(args.games),
            "--num-channels", str(args.channels),
            "--num-blocks", str(args.blocks), *extra]
    if args.ladder_features:
        argv.append("--ladder-features")
    if args.no_fused:
        argv.append("--no-fused")
    return cli.build_parser().parse_args(argv)


def _search_config(args, cli_args):
    import dataclasses

    from . import cli

    cfg = cli.search_config(cli_args, args.device)
    return dataclasses.replace(cfg, feature_kernel=args.feature_kernel)


def _table(snap: dict) -> dict:
    """A snapshot's spans by self seconds, and its counters."""
    return {"spans": dict(sorted(snap["spans"].items(),
                                 key=lambda kv: -kv[1]["self_s"])),
            "counters": dict(sorted(snap["counters"].items()))}


def span_table(args) -> dict:
    """Self-play under ``spans.recording()``: the wall time, the games
    completed and the span table."""
    from . import cli
    from .config import SelfPlayConfig
    from .selfplay import search_play as SP

    cli_args = _cli_args(args, ("--max-moves", str(args.moves),
                                "--seed", "0"))
    predictor = cli.load_predictor(cli_args, args.device)
    cfg = _search_config(args, cli_args)
    with spans.recording():
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
    return {"wall_s": wall, "games": len(games), **_table(spans.snapshot())}


def profile_window(args) -> dict:
    """torch.profiler over a few lockstep simulations of one search."""
    from torch.profiler import ProfilerActivity, profile

    from . import cli
    from .go import benson, engine
    from .mcts import search as S

    cli_args = _cli_args(args)
    dev = args.device
    predictor = cli.load_predictor(cli_args, dev)
    cfg = _search_config(args, cli_args)
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
    return dict(sims=args.profile_sims,
                **_device_time(prof, time.perf_counter() - t0),
                **_table(spans.snapshot()))


def _device_time(prof, wall: float) -> dict:
    """A profiler window's device time by kernel and idle share."""
    kernels = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += evt.self_device_time_total
    busy_us = sum(kernels.values())
    top = [{"kernel": k[:90], "ms": v / 1e3}
           for k, v in kernels.most_common(12)]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
            "top_kernels": top}


def train_window(args) -> dict:
    """torch.profiler over ``--train-steps`` steps of the trainer."""
    from torch.profiler import ProfilerActivity, profile

    from .config import ModelConfig, TrainConfig
    from .train.pipeline import ExampleSource
    from .train.train_loop import Trainer

    dev = args.device
    with open(args.train_data) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    src = ExampleSource(lines, args.batch_size, seed=0, positions_per_game=8,
                        bank_games=args.bank_games, device=dev)
    trainer = Trainer.create(
        ModelConfig(num_channels=args.channels, num_blocks=args.blocks),
        TrainConfig(batch_size=args.batch_size), device=dev)
    trainer.fit(src, 3, log_every=0)  # warm-up; builds the bank
    _sync()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trainer.fit(src, args.train_steps, log_every=0)
        _sync()
    wall = time.perf_counter() - t0
    return dict(steps=args.train_steps, batch=args.batch_size,
                ms_per_step=wall * 1e3 / args.train_steps,
                **_device_time(prof, wall), **_table(spans.snapshot()))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dream_go_torch.trace")
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--rollouts", type=int, default=64)
    parser.add_argument("--moves", type=int, default=3)
    parser.add_argument("--profile-sims", type=int, default=8)
    parser.add_argument("--channels", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=9)
    parser.add_argument("--ladder-features", action="store_true",
                        help="compute ladder planes 30/31")
    parser.add_argument("--no-fused", action="store_true",
                        help="the unfused leaf path (rules engine + "
                             "feature extraction)")
    parser.add_argument("--feature-kernel", action="store_true",
                        help="root evals and unfused leaves take the "
                             "liberties-after feature kernel")
    parser.add_argument("--train", action="store_true",
                        help="profile the trainer's steps instead")
    parser.add_argument("--train-steps", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=2048)
    parser.add_argument("--bank-games", type=int, default=1024)
    parser.add_argument("--train-data", default="models/rl20/gen_0000.sgf")
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
    if args.train:
        print(json.dumps({"train": train_window(args)}), flush=True)
        return
    print(json.dumps({"span_table": span_table(args)}), flush=True)
    print(json.dumps({"profile": profile_window(args)}), flush=True)


if __name__ == "__main__":
    main()
