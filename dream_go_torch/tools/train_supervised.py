"""Supervised training with a held-out accuracy curve (port of
`tools/train_supervised.py`).

Reproduces the reference's human-game bootstrap measurement
(`contrib/trainer/dream_tf/model_fn.py:160-183`, `README.md:21-45`):
train ``--start``-style from a big-SGF corpus and record policy
top-1/3/5, value-sign and ownership accuracy on a held-out split against
training steps.  The default corpus is the rl20 run's last generation,
`models/rl20/gen_0047.sgf` (256 self-play games), with 10 games held
out; the reference's 99-game professional fixture is not in the
repository.

Writes one JSONL row per evaluation: ``{"step": n, "split": "train" |
"holdout", "loss": ..., "policy_top1": ..., ...}`` (the train rows also
carry ``learning_rate``, ``lr_slope`` and ``lr_p_decreasing``).

    python -m dream_go_torch.tools.train_supervised [--games PATH]
        [--channels 128 --blocks 9] [--holdout 10] [--steps 4000]
        [--eval-every 200] [--batch 512] [--ladder-features]
        [--metrics OUT.jsonl] [--dump WEIGHTS.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import torch

from ..config import ModelConfig, TrainConfig
from ..train.pipeline import ExampleSource
from ..train.train_loop import Trainer, policy_bias_from_lines

DEFAULT_GAMES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "models", "rl20", "gen_0047.sgf")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.train_supervised")
    ap.add_argument("--games", default=DEFAULT_GAMES)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--num-samples", type=int, default=8)
    ap.add_argument("--holdout", type=int, default=10,
                    help="games held out for the accuracy curve")
    ap.add_argument("--holdout-games", default=None,
                    help="a separate held-out corpus file; overrides "
                         "--holdout")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--positions-per-game", type=int, default=8)
    ap.add_argument("--bank-games", type=int, default=0,
                    help="banked replay (0: per-batch replay)")
    ap.add_argument("--ladder-features", action="store_true")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--dump", default=None,
                    help="write the final weights JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def split_corpus(args):
    """``(train lines, held-out lines)``: the corpus shuffled by
    ``random.Random(seed)``, its first ``--holdout`` games held out."""
    with open(args.games) as fh:
        lines = [l.strip() for l in fh if l.strip()]
    random.Random(args.seed).shuffle(lines)
    if args.holdout_games:
        with open(args.holdout_games) as fh:
            return lines, [l.strip() for l in fh if l.strip()]
    return lines[args.holdout:], lines[:args.holdout]


def make_source(args, lines: list[str], seed: int, device) -> ExampleSource:
    return ExampleSource(lines, batch_size=args.batch, seed=seed,
                         ladder_features=args.ladder_features,
                         positions_per_game=args.positions_per_game,
                         bank_games=args.bank_games, device=device)


def rounded(row: dict) -> dict:
    return {k: round(float(v), 4) for k, v in row.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    train, holdout = split_corpus(args)
    print(f"corpus: {len(train)} train / {len(holdout)} held-out games",
          file=sys.stderr)

    mcfg = ModelConfig(num_channels=args.channels, num_blocks=args.blocks,
                       num_samples=args.num_samples,
                       ladder_features=args.ladder_features)
    tcfg = TrainConfig(batch_size=args.batch)
    trainer = Trainer.create(mcfg, tcfg, seed=args.seed,
                             policy_bias=policy_bias_from_lines(train),
                             device=device)

    train_src = make_source(args, train, args.seed, device)
    hold_src = make_source(args, holdout, args.seed + 1, device)
    out = open(args.metrics, "w") if args.metrics else None

    def emit(row):
        line = json.dumps(row)
        if out:
            out.write(line + "\n")
            out.flush()
        print(line, file=sys.stderr)

    def dump_now():
        if args.dump:
            tmp = args.dump + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(trainer.dump_json())
            os.replace(tmp, args.dump)

    step = 0
    while step < args.steps:
        chunk = min(args.eval_every, args.steps - step)
        last = trainer.fit(train_src, num_steps=chunk, log_every=0,
                           log_fn=lambda m: None)
        step = trainer.step
        hold = trainer.evaluate(hold_src, num_batches=args.eval_batches)
        emit({"step": step, "split": "train", **rounded(last)})
        emit({"step": step, "split": "holdout", **rounded(hold)})
        dump_now()  # at every evaluation, so a failure costs one interval
        if trainer.scheduler.should_stop:
            print("plateau scheduler stop", file=sys.stderr)
            break
    if out:
        out.close()
    if args.dump:
        dump_now()
        print(f"dumped weights to {args.dump}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
