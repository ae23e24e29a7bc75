"""Boards from raw stone lists, and the ladder stress boards.

:func:`from_stones` builds a GoState from 361-entry stone lists (0 empty,
1 black, 2 white), its chain ids by flood fill.  :func:`ladder_stress`
gives the boards that push the ladder readers to their bounds, rebuilt
from the JAX package's tests (`tests/test_ladder_stress.py`
``staircase_board``, `tests/test_ladder_bounds.py` swarms); the card
tests and `chip_smoke.py` hold the ladder kernel to its plain version on
them.
"""

from __future__ import annotations

import torch

from .engine import BLACK, GoState, new_states
from .topology import NN

#: the staircase's capture start: black at (3, 2) ladders the white stone
#: at (2, 2) across the board in 31 rungs (62 with the alternates read)
STAIRCASE_START = 19 * 3 + 2


def chain_ids(stones) -> list[int]:
    """Min-member chain ids of a 361 stones list (flood fill)."""
    cid = list(range(NN))
    seen = [False] * NN
    for p in range(NN):
        if stones[p] == 0 or seen[p]:
            continue
        group, todo = [], [p]
        seen[p] = True
        while todo:
            q = todo.pop()
            group.append(q)
            r, c = divmod(q, 19)
            for nb, ok in ((q - 19, r > 0), (q - 1, c > 0),
                           (q + 1, c < 18), (q + 19, r < 18)):
                if ok and stones[nb] == stones[p] and not seen[nb]:
                    seen[nb] = True
                    todo.append(nb)
        for q in group:
            cid[q] = min(group)
    return cid


def from_stones(boards, device, to_move: int = BLACK) -> GoState:
    """A batch of fresh GoStates holding ``boards`` (361 stones lists),
    ``to_move`` to play."""
    states = new_states(len(boards), device=device)
    return states.replace(
        stones=torch.tensor(boards, dtype=torch.int8, device=device),
        chain_id=torch.tensor([chain_ids(b) for b in boards],
                              dtype=torch.int32, device=device),
        to_move=torch.full((len(boards),), to_move, dtype=torch.int8,
                           device=device))


def ladder_stress() -> list[list[int]]:
    """Four stones lists, black to move: the 31-rung staircase, the same
    broken by a white stone at (17, 17), the 48-capture swarm and the
    12-escape swarm."""
    pt = lambda r, c: 19 * r + c
    stair = [0] * NN
    stair[pt(2, 2)] = 2
    for rc in ((1, 2), (2, 1), (1, 3)):
        stair[pt(*rc)] = 1
    broken = list(stair)
    broken[pt(17, 17)] = 2
    caps = [0] * NN
    for r in (2, 7, 12, 17):
        for c in (1, 4, 7, 10, 13, 16):
            caps[pt(r, c)] = 2
            for rc in ((r, c - 1), (r, c + 1), (r - 2, c), (r - 1, c - 1),
                       (r - 1, c + 1)):
                caps[pt(*rc)] = 1
    escs = [0] * NN
    for r in (2, 6, 10, 14):
        for c in (3, 10, 16):
            escs[pt(r, c)] = 1
            for rc in ((r + 1, c - 2), (r + 1, c + 2)):
                escs[pt(*rc)] = 1
            for rc in ((r, c - 1), (r, c + 1), (r - 1, c), (r + 2, c)):
                escs[pt(*rc)] = 2
    return [stair, broken, caps, escs]
