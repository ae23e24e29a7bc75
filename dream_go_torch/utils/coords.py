"""Board coordinate codecs (port of `dream_go_tpu/utils/coords.py`).

A point is a flat index ``p = 19*y + x`` in ``[0, 361)``; 361 is a pass.
CGoban SGF coordinates are two lowercase letters, column then row, and the
empty string for a pass (`sgf.rs:34-68`).
"""

from __future__ import annotations

N = 19
NN = N * N
PASS = NN

_SGF_LETTERS = "abcdefghijklmnopqrs"


def to_sgf(p: int) -> str:
    """CGoban coordinates; empty string for pass."""
    if p == PASS or p < 0:
        return ""
    return _SGF_LETTERS[p % N] + _SGF_LETTERS[p // N]


def from_sgf(s: str) -> int:
    """Parse CGoban coordinates; '' or 'tt' is a pass."""
    if s == "" or s == "tt":
        return PASS
    if len(s) != 2:
        raise ValueError(f"bad SGF coordinate {s!r}")
    return N * _SGF_LETTERS.index(s[1]) + _SGF_LETTERS.index(s[0])
