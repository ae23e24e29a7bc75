"""Add ``TB[]``/``TW[]`` territory labels to big-SGF games (port of
`tools/sgf2territory.py`, the reference's `tools/sgf2territory.py`):
replay each game of stdin, Benson-clear its final board and label the
ownership of every point; lines that do not parse pass through
unchanged.

    python -m dream_go_torch.tools.sgf2territory [--device cuda|cpu] \\
        < games.sgf > labelled.sgf
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..go import benson
from ..utils import coords
from .sgf2score import device_parser, final_states


def label(lines: list[str], device="cuda") -> list[str]:
    import torch

    lines = list(lines)
    idx, states = final_states(lines, torch.device(device))
    if not idx:
        return lines
    _, terr = benson.stone_status(states.stones, states.chain_id,
                                  states.stones, states.chain_id)
    terr = terr.cpu().numpy()
    for row, i in enumerate(idx):
        line = re.sub(r"T[BW](\[[a-z]{2}\])+", "", lines[i])
        tb = "".join(f"[{coords.to_sgf(int(p))}]"
                     for p in np.flatnonzero(terr[row] == 1))
        tw = "".join(f"[{coords.to_sgf(int(p))}]"
                     for p in np.flatnonzero(terr[row] == 2))
        suffix = (f"TB{tb}" if tb else "") + (f"TW{tw}" if tw else "")
        lines[i] = line[:-1] + suffix + ")" if line.endswith(")") \
            else line + suffix
    return lines


def main(argv=None) -> int:
    args = device_parser("dream_go_torch.tools.sgf2territory").parse_args(
        argv)
    lines = [l.strip() for l in sys.stdin if l.strip()]
    for line in label(lines, args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
