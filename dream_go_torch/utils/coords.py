"""Board coordinate codecs (port of `dream_go_tpu/utils/coords.py`).

A point is a flat index ``p = 19*y + x`` in ``[0, 361)``; 361 is a pass.

- CGoban SGF coordinates (`sgf.rs:34-68`): two lowercase letters, column
  then row, and the empty string for a pass;
- Sabaki SGF coordinates (`sgf.rs:70-92`): CGoban's with the rows flipped;
- GTP vertices (`gtp/vertex.rs`): a column letter (no I) and a 1-based row
  counted from the bottom.
"""

from __future__ import annotations

N = 19
NN = N * N
PASS = NN

_SGF_LETTERS = "abcdefghijklmnopqrs"
_GTP_LETTERS = "ABCDEFGHJKLMNOPQRST"  # no I


def point(x: int, y: int) -> int:
    return N * y + x


def point_xy(p: int) -> tuple[int, int]:
    return p % N, p // N


def to_sgf(p: int) -> str:
    """CGoban coordinates; empty string for pass."""
    if p == PASS or p < 0:
        return ""
    x, y = point_xy(p)
    return _SGF_LETTERS[x] + _SGF_LETTERS[y]


def from_sgf(s: str) -> int:
    """Parse CGoban coordinates; '' or 'tt' is a pass."""
    if s == "" or s == "tt":
        return PASS
    if len(s) != 2:
        raise ValueError(f"bad SGF coordinate {s!r}")
    return point(_SGF_LETTERS.index(s[0]), _SGF_LETTERS.index(s[1]))


def to_sabaki(p: int) -> str:
    if p == PASS or p < 0:
        return ""
    x, y = point_xy(p)
    return _SGF_LETTERS[x] + _SGF_LETTERS[18 - y]


def from_sabaki(s: str) -> int:
    p = from_sgf(s)
    if p == PASS:
        return p
    x, y = point_xy(p)
    return point(x, 18 - y)


def to_gtp(p: int) -> str:
    if p == PASS or p < 0:
        return "pass"
    x, y = point_xy(p)
    return f"{_GTP_LETTERS[x]}{19 - y}"


def from_gtp(s: str) -> int:
    """Parse a GTP vertex; ``pass`` and ``resign`` are a pass."""
    s = s.strip().lower()
    if s in ("pass", "resign"):
        return PASS
    x = _GTP_LETTERS.index(s[0].upper())
    y = 19 - int(s[1:])
    if not (0 <= y < N):
        raise ValueError(f"bad GTP vertex {s!r}")
    return point(x, y)
