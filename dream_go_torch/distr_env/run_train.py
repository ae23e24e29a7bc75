"""Trainer: consume new games from shared storage, train, publish weights
(port of `contrib/distr-env/run_train.py`).

    python -m dream_go_torch.distr_env.run_train --root /data \\
        --steps-per-gen 2000 [--device cuda|cpu]

It waits for ``--min-new-games`` fresh games, trains ``--steps-per-gen``
steps of :class:`~dream_go_torch.train.train_loop.Trainer` over the
sliding window of the last ``--window-games`` games, then publishes the
next generation, the weights JSON of the learner's parameters (BN folded,
as the JAX trainer publishes its ``state.params``), through an atomic
rename, and checkpoints itself.  The checkpoint is one ``torch.save``
file, ``ROOT/trainer_ckpt.pt``; it resumes from it on restart (the JAX
trainer's orbax directory ``ROOT/trainer_ckpt`` is neither read nor
written).  ``--ladder-features`` trains a net that reads planes 30/31, and
its published weights say so; ``--bank-games`` and
``--positions-per-game`` build each generation's examples from one
example bank, as the CLI's trainer does.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

from ..config import ModelConfig, TrainConfig
from ..train.pipeline import ExampleSource
from ..train.rl_loop import raw_weights_json
from ..train.train_loop import Trainer
from ..utils.device import resolve
from . import dg_storage

CHECKPOINT = "trainer_ckpt.pt"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.distr_env.run_train")
    ap.add_argument("--root", required=True)
    ap.add_argument("--num-channels", type=int, default=128)
    ap.add_argument("--num-blocks", type=int, default=9)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--steps-per-gen", type=int, default=2000)
    ap.add_argument("--min-new-games", type=int, default=256,
                    help="wait for at least this many fresh games per gen")
    ap.add_argument("--window-games", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=0,
                    help="stop after N generations (0 = run forever)")
    ap.add_argument("--poll-seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ladder-features", action="store_true",
                    help="train a net that reads planes 30/31")
    ap.add_argument("--positions-per-game", type=int, default=1)
    ap.add_argument("--bank-games", type=int, default=0,
                    help="games replayed into one example bank a "
                         "generation (0: fresh games every batch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    model_cfg = ModelConfig(num_channels=args.num_channels,
                            num_blocks=args.num_blocks,
                            ladder_features=args.ladder_features)
    train_cfg = TrainConfig(batch_size=args.batch_size)
    ckpt = os.path.abspath(os.path.join(args.root, CHECKPOINT))
    if os.path.isfile(ckpt):
        trainer = Trainer.restore(ckpt, train_cfg, device=device)
        model_cfg = trainer.model_cfg
        print(f"trainer: resumed from {ckpt}", flush=True)
    else:
        trainer = Trainer.create(model_cfg, train_cfg, seed=args.seed,
                                 device=device)

    gen, _ = dg_storage.latest_weights(args.root)
    pool: collections.deque[str] = collections.deque(
        maxlen=args.window_games)
    seen: set[str] = set()
    done = 0
    pending = 0  # fresh games accumulated since the last generation
    while args.rounds == 0 or done < args.rounds:
        fresh, seen = dg_storage.new_games(args.root, seen)
        pool.extend(fresh)
        pending += len(fresh)
        if pending < args.min_new_games:
            time.sleep(args.poll_seconds)
            continue
        pending = 0
        source = ExampleSource(list(pool), batch_size=args.batch_size,
                               seed=args.seed + done,
                               ladder_features=model_cfg.ladder_features,
                               positions_per_game=args.positions_per_game,
                               bank_games=args.bank_games, device=device)
        metrics = trainer.fit(source, args.steps_per_gen, log_every=0)
        gen += 1
        path = dg_storage.publish_weights(args.root, gen,
                                          raw_weights_json(trainer))
        trainer.save(ckpt)
        print(f"trainer: gen {gen} loss {metrics.get('loss', 0.0):.4f} "
              f"pool {len(pool)} -> {path}", flush=True)
        done += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
