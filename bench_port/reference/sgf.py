"""The recorded games' moves and training labels, read plainly from the
SGF text (one game a line, no variations: the search's own records).

- moves: ``;B[..]`` / ``;W[..]`` in order, ``tt`` or an empty value a
  pass (361); a game whose result carries a score and that does not end
  in two passes is given them;
- policy label at a position: the move's recorded search distribution
  (``P[..]``, base85 float16, 362 entries; scaled to sum to 1 where the
  rounded entries sum to more) with the mass it lacks of 1 added at the
  move played, else a one-hot of the move played;
- value label: 1 if the side to move won, -1 if it lost, 0 if no winner;
- ownership label: 1 on the side to move's territory (``TB`` / ``TW``),
  -1 on the other side's, and whether the game records any territory.
"""

from __future__ import annotations

import base64
import dataclasses
import re

import numpy as np

PASS = 361
_MOVE = re.compile(r";([BW])\[([a-s]{2}|tt|)\]")
_POLICY = re.compile(r"P\[([^\]]*)\]")
_RESULT = re.compile(r"RE\[([^\]]*)\]")
_KOMI = re.compile(r"KM\[([+-]?[0-9.]+)\]")


@dataclasses.dataclass
class Game:
    moves: list[int]
    colors: list[int]             # 1 black, 2 white
    policies: list[str | None]    # the raw P[] payload of each move
    winner: int                   # 1, 2, or 0
    komi: float
    territory: dict               # colour -> points


def _point(at: str) -> int:
    if at in ("", "tt"):
        return PASS
    return (ord(at[1]) - 97) * 19 + ord(at[0]) - 97


def _territory(line: str, prop: str) -> list[int]:
    m = re.search(prop + r"((?:\[[a-s]{2}\])+)", line)
    return [_point(a) for a in re.findall(r"\[([a-s]{2})\]", m.group(1))] \
        if m else []


def move_key(line: str) -> tuple:
    """The game's moves without its trailing passes: what identifies it
    among the records."""
    moves = [_point(at) for _, at in _MOVE.findall(line)]
    while moves and moves[-1] == PASS:
        moves.pop()
    return tuple(moves)


def _scored(result: str) -> bool:
    if "+" not in result:
        return False
    try:
        float(result.split("+", 1)[1])
    except ValueError:
        return False
    return True


def parse(line: str) -> Game:
    found = list(_MOVE.finditer(line))
    moves, colors, policies = [], [], []
    for i, m in enumerate(found):
        moves.append(_point(m.group(2)))
        colors.append(1 if m.group(1) == "B" else 2)
        end = found[i + 1].start() if i + 1 < len(found) else len(line)
        p = _POLICY.search(line, m.end(), end)
        policies.append(p.group(1) if p else None)
    res = _RESULT.search(line)
    result = res.group(1) if res else ""
    winner = 1 if result.startswith("B") else 2 if result.startswith("W") \
        else 0
    if _scored(result):
        trailing = 0
        while trailing < len(moves) and moves[-1 - trailing] == PASS:
            trailing += 1
        for _ in range(max(0, 2 - trailing)):
            moves.append(PASS)
            colors.append(3 - colors[-1] if colors else 1)
            policies.append(None)
    komi = _KOMI.search(line)
    return Game(moves, colors, policies, winner,
                float(komi.group(1)) if komi else 7.5,
                {1: _territory(line, "TB"), 2: _territory(line, "TW")})


def labels(game: Game, pos: int) -> dict:
    """The labels of the example at move ``pos`` (before it is played)."""
    color = game.colors[pos]
    policy = np.zeros(362, np.float32)
    if game.policies[pos] is not None:
        blob = np.frombuffer(base64.b85decode(game.policies[pos]),
                             np.float16)
        policy[:] = blob[:362].astype(np.float32)
        policy[~np.isfinite(policy) | (policy < 0)] = 0.0
    total = float(policy.sum())
    if total > 1.0:  # float16 entries that sum to more than 1
        policy /= np.float32(total)
        total = 1.0
    policy[game.moves[pos]] += np.float32(1.0 - total)
    value = 0.0 if game.winner == 0 else 1.0 if game.winner == color else -1.0
    owner = np.zeros(361, np.int8)
    owner[game.territory[1]] = 1
    owner[game.territory[2]] = 2   # a point in both lists is white's
    own = np.where(owner == color, 1.0,
                   np.where(owner == 0, 0.0, -1.0)).astype(np.float32)
    return {"policy": policy, "value": np.float32(value), "ownership": own,
            "has_ownership": np.float32(float(own.any()))}
