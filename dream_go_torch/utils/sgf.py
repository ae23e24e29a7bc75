"""Host-side SGF parsing (big-SGF: one game per line).

Port of `dream_go_tpu/utils/sgf.py` (``parse_line``, ``get_komi``,
``get_winner``, ``is_scored``; `src/libdg_go/utils/sgf.rs`).  The dialect
is the reference's own self-play output (`self_play.rs:187-214`,
`game_result.rs:22-44`):

    (;GM[1]FF[4]DT[...]SZ[19]RU[Chinese]KM[7.5]RE[B+2.5]
      ;B[dd]TV[1600]P[<b85 softmax>]V[0.1234];W[pp]...TB[..][..]TW[..])

Per-move annotations: ``TV[n]`` rollout count, ``P[...]`` b85-encoded f16
policy softmax (362 entries), ``V[x]`` black-perspective value.  Only the
main line is read (variations are skipped as whole subtrees).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from . import b85, coords

_MOVE_RE = re.compile(r";\s*([BW])\[([a-z]{0,2})\]")
_PROP_RE = re.compile(r"([A-Z]{1,2})\[([^\]]*)\]")
_KOMI_RE = re.compile(r"KM\[([+-]?[0-9.]+)\]")
_RESULT_RE = re.compile(r"RE\[([^\]]*)\]")


@dataclasses.dataclass
class SgfMove:
    color: int                      # 1 black / 2 white
    point: int                      # 0..360, 361 = pass
    policy: np.ndarray | None = None  # f16[362] softmax, if P[] present
    value: float | None = None      # black-perspective value from V[]
    num_rollout: int | None = None  # TV[]


@dataclasses.dataclass
class SgfGame:
    komi: float
    winner: int                     # 1 / 2 / 0 (draw or unknown)
    score: float | None             # e.g. 2.5 for B+2.5; None for Resign/Time
    by_resign: bool
    moves: list[SgfMove]
    black_territory: list[int]
    white_territory: list[int]


def parse_line(line: str) -> SgfGame | None:
    """Parse one game (main line only); None if there is no move."""
    komi_m = _KOMI_RE.search(line)
    komi = float(komi_m.group(1)) if komi_m else 7.5

    winner, score, by_resign = 0, None, False
    res_m = _RESULT_RE.search(line)
    if res_m:
        res = res_m.group(1)
        if res.startswith("B"):
            winner = 1
        elif res.startswith("W"):
            winner = 2
        if "+" in res:
            tail = res.split("+", 1)[1]
            if tail in ("Resign", "R"):
                by_resign = True
            else:
                try:
                    score = float(tail)
                except ValueError:
                    pass

    # keep the main line only: the FIRST child at every node (later sibling
    # variations are skipped as whole subtrees, `sgf.rs:242-267`).  Sabaki
    # and review tools wrap each mainline move in its own nested variation,
    # so mainline content can sit at any depth.  Parens only count outside
    # property values — b85 payloads (P[...]) legally contain '(' / ')'.
    out_chars = []
    depth = 0
    skip_depth = None       # set => skipping a non-first sibling subtree
    child_seen = [0]        # variations opened directly at each depth
    in_prop = False
    for ch in line:
        if in_prop:
            if skip_depth is None:
                out_chars.append(ch)
            if ch == "]":
                in_prop = False
            continue
        if ch == "(":
            if skip_depth is None and child_seen[depth] > 0:
                skip_depth = depth + 1
            child_seen[depth] += 1
            depth += 1
            if len(child_seen) <= depth:
                child_seen.append(0)
            else:
                child_seen[depth] = 0
            continue
        if ch == ")":
            depth -= 1
            if skip_depth is not None and depth < skip_depth:
                skip_depth = None
            continue
        if ch == "[":
            in_prop = True
        if skip_depth is None:
            out_chars.append(ch)
    main = "".join(out_chars)

    moves: list[SgfMove] = []
    for m in _MOVE_RE.finditer(main):
        color = 1 if m.group(1) == "B" else 2
        try:
            point = coords.from_sgf(m.group(2))
        except ValueError:
            return None
        mv = SgfMove(color=color, point=point)
        # scan annotations up to the next move token
        tail = main[m.end():]
        nxt = _MOVE_RE.search(tail)
        annos = tail[: nxt.start()] if nxt else tail
        for pm in _PROP_RE.finditer(annos):
            key, val = pm.group(1), pm.group(2)
            if key == "P":
                try:
                    mv.policy = b85.decode(val, np.float16)
                except Exception:
                    mv.policy = None
            elif key == "V":
                try:
                    mv.value = float(val)
                except ValueError:
                    pass
            elif key == "TV":
                try:
                    mv.num_rollout = int(val)
                except ValueError:
                    pass
        moves.append(mv)

    if not moves:
        return None

    def _territory(prop: str) -> list[int]:
        out = []
        m = re.search(prop + r"((?:\[[a-z]{2}\])+)", line)
        if m:
            for c in re.finditer(r"\[([a-z]{2})\]", m.group(1)):
                out.append(coords.from_sgf(c.group(1)))
        return out

    return SgfGame(komi=komi, winner=winner, score=score, by_resign=by_resign,
                   moves=moves, black_territory=_territory("TB"),
                   white_territory=_territory("TW"))


def get_komi(line: str) -> float:
    """`sgf.rs:308` get_komi_from_sgf."""
    m = _KOMI_RE.search(line)
    return float(m.group(1)) if m else 7.5


def get_winner(line: str) -> int:
    """`sgf.rs:340` get_winner_from_sgf: 1/2/0."""
    m = _RESULT_RE.search(line)
    if not m:
        return 0
    return 1 if m.group(1).startswith("B") else 2 if m.group(1).startswith("W") else 0


def is_scored(line: str) -> bool:
    """`sgf.rs:362`: RE[] carries a numeric margin."""
    m = _RESULT_RE.search(line)
    if not m or "+" not in m.group(1):
        return False
    tail = m.group(1).split("+", 1)[1]
    try:
        float(tail)
        return True
    except ValueError:
        return False
