"""Command-line front end of the port: continuous full-search self-play.

    python -m dream_go_torch.cli --self-play N --continuous \\
        --num-rollout R --num-games B [--max-moves M] [--seed S] \\
        [--weights dream_go.json] [--device cuda|cpu]

writes one SGF line per finished game to stdout, as
`dream_go_tpu/cli.py:230-253` does.  Without ``--weights`` the net is a
seeded random tower at the ``ModelConfig`` width (128 x 9 unless
``--num-channels``/``--num-blocks`` say otherwise).  The fused leaf kernel
and EARLY-C termination are on for ``cuda`` (``--no-fused`` and
``--no-adaptive`` turn them off).  On ``cpu`` the tower computes in
float32.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config import ModelConfig, SearchConfig, SelfPlayConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dream_go_torch")
    parser.add_argument("--self-play", type=int, metavar="N",
                        help="generate N self-play games")
    parser.add_argument("--continuous", action="store_true",
                        help="continuous batching: finished games are "
                             "replaced by fresh ones; --num-games is the "
                             "live batch width")
    parser.add_argument("--weights", help="dream_go.json weights file")
    parser.add_argument("--num-rollout", type=int, default=1600)
    parser.add_argument("--num-games", type=int, default=128)
    parser.add_argument("--num-channels", type=int, default=128)
    parser.add_argument("--num-blocks", type=int, default=9)
    parser.add_argument("--num-samples", type=int, default=8)
    parser.add_argument("--softmax-temperature", type=float, default=1.0)
    parser.add_argument("--komi", type=float, default=7.5)
    parser.add_argument("--max-moves", type=int, default=None,
                        help="cap game length (default 722)")
    parser.add_argument("--no-fused", action="store_true",
                        help="disable the fused leaf_step kernel")
    parser.add_argument("--no-adaptive", action="store_true",
                        help="disable EARLY-C chunked early termination")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    return parser


def load_predictor(args, device):
    """The net: ``--weights`` through ``load_json``, else a seeded random
    tower at the configured width."""
    from .mcts import predictor as P
    from .models import params as MP
    from .models import tower as T

    dtype = None if torch.device(device).type == "cuda" else "float32"
    if args.weights:
        with open(args.weights) as fh:
            cfg, folded = MP.load_json(fh.read())
        if cfg.ladder_features:
            raise NotImplementedError(
                "this net needs ladder planes 30/31, which the port does "
                "not compute yet")
        model = T.from_state_dict(cfg, MP.to_state_dict(cfg, folded),
                                  device, dtype)
    else:
        cfg = ModelConfig(num_channels=args.num_channels,
                          num_blocks=args.num_blocks,
                          num_samples=args.num_samples)
        model = T.init_tower(cfg, seed=0, device=device, dtype=dtype)
    return P.net_predictor(model, softmax_temp=args.softmax_temperature)


def search_config(args, device) -> SearchConfig:
    cfg = SearchConfig(num_rollout=args.num_rollout,
                       fused=False if args.no_fused else None,
                       adaptive=False if args.no_adaptive else None)
    return cfg.resolve_auto(device)


def self_play(args, stats: dict | None = None) -> list[str]:
    """Run ``--self-play N --continuous`` and return the SGF lines."""
    from .selfplay.search_play import search_self_play_continuous

    device = torch.device(args.device)
    predictor = load_predictor(args, device)
    extra = {} if args.max_moves is None else {"max_moves": args.max_moves}
    cfg = SelfPlayConfig(num_games=args.self_play,
                         num_rollout=args.num_rollout, komi=args.komi,
                         **extra)
    return search_self_play_continuous(
        predictor, cfg, search_config(args, device), seed=args.seed,
        batch=min(args.self_play, args.num_games), stats=stats,
        device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.self_play and args.continuous and args.num_rollout > 1):
        print("dream_go_torch: only --self-play N --continuous with "
              "--num-rollout > 1 is ported so far", file=sys.stderr)
        return 2
    for line in self_play(args):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
