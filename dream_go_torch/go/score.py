"""Tromp-Taylor scoring and territory by iterated dilation.

Port of `dream_go_tpu/go/score.py`: a point counts for black if it holds a
black stone or is empty and reachable from black stones only; ditto white
(`score.rs:220-241`).
"""

from __future__ import annotations

import torch

from .engine import BLACK, EMPTY, WHITE, GoState, gather_nbr

#: dilation steps between two convergence checks (one host sync each)
CHECK_EVERY = 8


def reachable(stones: torch.Tensor, color) -> torch.Tensor:
    """bool[B, 361]: points reachable from ``color`` stones through empties
    (`score.rs:247-282` ``get_territory_distance != 0xff``)."""
    r = stones == color
    empty = stones == EMPTY
    while True:
        prev = r
        for _ in range(CHECK_EVERY):
            r = r | (empty & gather_nbr(r, False).any(-1))
        if torch.equal(r, prev):
            return r


def territory(stones: torch.Tensor):
    """(black_terr, white_terr) bool[B, 361] single-color territory."""
    rb = reachable(stones, BLACK)
    rw = reachable(stones, WHITE)
    empty = stones == EMPTY
    return empty & rb & ~rw, empty & rw & ~rb


def tt_score(stones: torch.Tensor):
    """Tromp-Taylor (black_points, white_points) int32[B], komi excluded;
    an empty board scores 0 for both (`score.rs:133-139`)."""
    any_stone = (stones != EMPTY).any(-1)
    tb, tw = territory(stones)
    black = ((stones == BLACK) | tb).sum(-1) * any_stone
    white = ((stones == WHITE) | tw).sum(-1) * any_stone
    return black.to(torch.int32), white.to(torch.int32)


def final_score(state: GoState) -> torch.Tensor:
    """float32[B]: black minus white minus komi (>0 = black wins)."""
    black, white = tt_score(state.stones)
    return black.float() - white.float() - state.komi
