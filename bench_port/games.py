"""Recorded games as traffic: the lines of the repository's self-play
records, and starting positions drawn from them by the seed.

Only the main line's moves are read (``;B[..]`` / ``;W[..]``, ``tt`` or an
empty value a pass); the search's records carry no variations.  The
policy payloads (``P[..]``) never hold ``[`` or ``]``, so a move cannot be
read out of one.
"""

from __future__ import annotations

import re

import numpy as np

from .harness import input_files

_MOVE = re.compile(r";([BW])\[([a-s]{2}|tt|)\]")
PASS = 361


def lines(spec: list[dict]) -> list[str]:
    """Every non-empty line of the mix's record files, in order."""
    out = []
    for path in input_files(spec):
        with open(path) as fh:
            out.extend(line.strip() for line in fh if line.strip())
    return out


def moves(line: str) -> np.ndarray | None:
    """int32 points of the game's moves up to its first pass (``y * 19 +
    x``), or None when the colours do not alternate from black."""
    out = []
    for i, (color, at) in enumerate(_MOVE.findall(line)):
        if color != "BW"[i % 2]:
            return None
        if at in ("", "tt"):
            break
        out.append((ord(at[1]) - 97) * 19 + ord(at[0]) - 97)
    return np.asarray(out, np.int32)


def starting_positions(games: list[np.ndarray], count: int, seed: int,
                       min_moves: int):
    """``count`` (game index, move number) pairs drawn from ``seed``: a
    game uniformly among those with at least ``min_moves`` moves before
    their first pass, then a move number uniformly in [0, its length]
    (the position before that move; passes never come before it)."""
    rng = np.random.default_rng(seed)
    usable = np.flatnonzero([len(g) >= min_moves for g in games])
    pick = usable[rng.integers(0, len(usable), count)]
    lengths = np.asarray([len(games[i]) for i in pick])
    at = (rng.random(count) * (lengths + 1)).astype(np.int64)
    return pick, np.minimum(at, lengths)


def padded(games: list[np.ndarray], pick, at) -> np.ndarray:
    """int32[count, T] moves of the picked games up to their positions,
    padded with passes; T rounded up to a multiple of 64."""
    t = int(max(at.max(initial=0), 1))
    t = (t + 63) // 64 * 64
    out = np.full((len(pick), t), PASS, np.int32)
    for row, (g, n) in enumerate(zip(pick, at)):
        out[row, :n] = games[g][:n]
    return out
