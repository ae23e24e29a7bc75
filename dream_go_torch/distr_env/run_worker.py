"""Self-play worker: poll for the newest published weights, play games,
push them to shared storage (port of `contrib/distr-env/run_worker.py`).

    python -m dream_go_torch.distr_env.run_worker --root /data \\
        --games 256 --num-rollout 1600 [--device cuda|cpu]

With ``--num-rollout 1`` the worker plays policy-sampled games (the
reference's NUM_ROLLOUT=1 mode); otherwise search self-play (the fused
search on the card).  Until a first generation is published it plays from
a seeded random net at ``--num-channels`` x ``--num-blocks``, so the
trainer has bootstrap data.  Planes 30/31 follow the weights' contract
(their ``ladder_features:0`` tensor; off for the random net), as the
CLI's ``--weights`` does, unless ``--ladder-features`` /
``--no-ladder-features`` say otherwise; on the card the exact ladder
kernel reads them.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

import torch

from ..config import SearchConfig, SelfPlayConfig
from ..tools.common import add_ladder_flags, load_net
from ..utils.device import resolve
from . import dg_storage


def build_predictor(path, args, device):
    """``(predictor, ladder_features)``: the weights at ``path`` through
    ``load_json``, or a seeded random tower where ``path`` is None; the
    planes contract is the weights' unless the flags chose."""
    predictor, cfg = load_net(path, args.num_channels, args.num_blocks,
                              device, seed=args.seed)
    ladders = cfg.ladder_features if args.ladder_features is None \
        else args.ladder_features
    return predictor, ladders


def play_round(predictor, ladders: bool, args, seed: int,
               device) -> list[str]:
    """One batch of ``--games`` games: policy play with ``--num-rollout
    1``, search self-play otherwise."""
    sp_cfg = SelfPlayConfig(num_games=args.games,
                            num_rollout=args.num_rollout,
                            max_moves=args.max_moves)
    if args.num_rollout <= 1:
        from ..selfplay.policy import PolicyPlayer, policy_self_play

        return policy_self_play(
            PolicyPlayer(predictor, ladder_features=ladders), sp_cfg,
            seed=seed, device=device)
    from ..selfplay.search_play import search_self_play

    search_cfg = SearchConfig(num_rollout=args.num_rollout,
                              ladder_features=ladders).resolve_auto(device)
    return search_self_play(predictor, sp_cfg, search_cfg, seed=seed,
                            device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.distr_env.run_worker")
    ap.add_argument("--root", required=True)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--num-rollout", type=int, default=1)
    ap.add_argument("--max-moves", type=int, default=722)
    ap.add_argument("--rounds", type=int, default=0,
                    help="stop after N batches (0 = run forever)")
    ap.add_argument("--num-channels", type=int, default=128)
    ap.add_argument("--num-blocks", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker-id",
                    default=f"{socket.gethostname()}-{os.getpid()}")
    add_ladder_flags(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    have_gen = -2  # force a first load
    predictor, ladders = None, False
    done = 0
    while args.rounds == 0 or done < args.rounds:
        gen, path = dg_storage.latest_weights(args.root)
        if gen != have_gen:
            predictor, ladders = build_predictor(path, args, device)
            have_gen = gen
            print(f"worker {args.worker_id}: weights generation {gen}",
                  flush=True)
        seed = args.seed + done * 7919 + max(gen, 0)
        with torch.no_grad():
            games = play_round(predictor, ladders, args, seed, device)
        out = dg_storage.append_games(args.root, args.worker_id, done, games)
        print(f"worker {args.worker_id}: {len(games)} games -> {out}",
              flush=True)
        done += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
