"""Opening-diversity statistics over a big-SGF stream (port of
`tools/sgf2stats.py`, the reference's `tools/sgf2stats.py`): unique
positions after k moves, game length and result distributions.

    python -m dream_go_torch.tools.sgf2stats [--device cuda|cpu] \\
        < games.sgf

Its output is the JAX tool's, byte for byte.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys

from ..utils import sgf
from ..utils.device import resolve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dream_go_torch.tools.sgf2stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; nothing here runs on "
                         "it)")
    resolve(ap.parse_args(argv).device)
    depths = (1, 2, 4, 8, 16)
    uniq = {d: set() for d in depths}
    lengths = []
    results = collections.Counter()
    for line in sys.stdin:
        game = sgf.parse_line(line.strip())
        if game is None:
            continue
        moves = [m.point for m in game.moves]
        lengths.append(len(moves))
        for d in depths:
            uniq[d].add(tuple(moves[:d]))
        m = re.search(r"RE\[([^\]]*)\]", line)
        results[m.group(1)[:2] if m else "?"] += 1

    n = len(lengths)
    if not n:
        print("no games", file=sys.stderr)
        return 1
    print(f"games: {n}")
    print(f"avg length: {sum(lengths) / n:.1f} "
          f"(min {min(lengths)}, max {max(lengths)})")
    for d in depths:
        print(f"unique openings at move {d:2d}: {len(uniq[d])}")
    for res, count in results.most_common():
        print(f"result {res}: {count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
