"""Convert Sabaki-coordinate SGF to CGoban coordinates (port of
`tools/sgf2cgoban.py`, the reference's `tools/sgf2cgoban.py`): flips the
row axis of every move and territory point.

    python -m dream_go_torch.tools.sgf2cgoban [--device cuda|cpu] \\
        < games.sgf

Its output is the JAX tool's, byte for byte.
"""

from __future__ import annotations

import argparse
import re
import sys

from ..utils import coords
from ..utils.device import resolve

PATTERN = re.compile(r"\b([BW]|TB|TW|TR|AB|AW)\[([a-z]{0,2})\]")


def _flip(m):
    prop, val = m.group(1), m.group(2)
    if len(val) == 2:
        p = coords.from_sabaki(val)
        return f"{prop}[{coords.to_sgf(p)}]"
    return m.group(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.sgf2cgoban")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; nothing here runs on "
                         "it)")
    resolve(ap.parse_args(argv).device)
    for line in sys.stdin:
        print(PATTERN.sub(_flip, line.rstrip("\n")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
