"""Convert SGF games to numpy test fixtures (port of `tools/sgf2array.py`;
the reference's `tools/sgf2array.py` emitted Rust test arrays): one
``.npz`` with each game's moves, colours, final stones, final hash and
komi, replayed on the port's engine.

    python -m dream_go_torch.tools.sgf2array out.npz [--device cuda|cpu] \\
        < games.sgf

The arrays and keys are the JAX tool's (``game{i}_moves`` int32,
``_colors`` int8, ``_stones`` int8[361], ``_hash`` uint32[2],
``_komi`` float32), ``i`` counting the non-empty input lines.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..go import engine
from ..utils import sgf
from ..utils.device import resolve


def game_arrays(game, device) -> dict:
    """The final position of one parsed game, each move played with the
    colour the SGF gives it."""
    s = engine.new_states(1, komi=game.komi, device=device)
    for mv in game.moves:
        s = engine.step(
            s.replace(to_move=torch.full((1,), mv.color, dtype=torch.int8,
                                         device=device)),
            torch.full((1,), mv.point, dtype=torch.int32, device=device))
    return {
        "moves": np.asarray([m.point for m in game.moves], np.int32),
        "colors": np.asarray([m.color for m in game.moves], np.int8),
        "stones": s.stones[0].cpu().numpy(),
        "hash": s.hash[0].cpu().numpy().view(np.uint32),
        "komi": np.float32(game.komi),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.sgf2array")
    ap.add_argument("out", nargs="?", default="games.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    arrays = {}
    for gi, line in enumerate(l.strip() for l in sys.stdin if l.strip()):
        game = sgf.parse_line(line)
        if game is None:
            continue
        for key, value in game_arrays(game, device).items():
            arrays[f"game{gi}_{key}"] = value
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {len(arrays) // 5} games to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
