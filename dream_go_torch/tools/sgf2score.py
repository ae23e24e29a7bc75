"""Re-score big-SGF games with the engine (port of `tools/sgf2score.py`,
the reference's `tools/sgf2score.py`).

Replays each game of stdin on the batched engine and rewrites ``RE[]``
with the Tromp-Taylor result after Benson clearing (``guess_score``) of
its final board; lines that do not parse pass through unchanged.

    python -m dream_go_torch.tools.sgf2score [--device cuda|cpu] \\
        < games.sgf > rescored.sgf
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from ..go import benson, engine
from ..selfplay.replay import states_at
from ..utils import sgf


def final_states(lines: list[str], device):
    """``(indices of the lines that parse, their final states)``."""
    parsed = [sgf.parse_line(l) for l in lines]
    idx = [i for i, g in enumerate(parsed) if g is not None]
    if not idx:
        return idx, None
    t_max = max(len(parsed[i].moves) for i in idx)
    moves = np.full((len(idx), t_max), engine.PASS, np.int32)
    lengths = np.zeros(len(idx), np.int32)
    komi = np.zeros(len(idx), np.float32)
    for row, i in enumerate(idx):
        seq = [m.point for m in parsed[i].moves]
        moves[row, :len(seq)] = seq
        lengths[row] = len(seq)
        komi[row] = parsed[i].komi
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return idx, states_at(t(moves), t(lengths), t(komi), 64)


def rescore(lines: list[str], device="cuda") -> list[str]:
    lines = list(lines)
    idx, states = final_states(lines, torch.device(device))
    if not idx:
        return lines
    scores = benson.guess_score(states.stones, states.chain_id,
                                states.komi).cpu().numpy()
    for row, i in enumerate(idx):
        s = float(scores[row])
        res = f"B+{s:.1f}" if s > 0 else f"W+{-s:.1f}" if s < 0 else "0"
        if re.search(r"RE\[[^\]]*\]", lines[i]):
            lines[i] = re.sub(r"RE\[[^\]]*\]", f"RE[{res}]", lines[i], 1)
        else:
            lines[i] = lines[i].replace(";B[", f"RE[{res}];B[", 1)
    return lines


def device_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    args = device_parser("dream_go_torch.tools.sgf2score").parse_args(argv)
    lines = [l.strip() for l in sys.stdin if l.strip()]
    for line in rescore(lines, args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
