"""Search-option candidate masks: StandardSearch vs ScoringSearch.

Port of `dream_go_tpu/go/options.py` (`options.rs`): ScoringSearch forbids
pass, points inside either color's Benson eyes, and filling one's own
heuristic eye.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .benson import benson
from .engine import BLACK, WHITE, GoState, legal_mask, pad
from .topology import NBR8, NN

_X = np.arange(NN) % 19
_Y = np.arange(NN) // 19
_IS_CORNER = ((_X == 0) | (_X == 18)) & ((_Y == 0) | (_Y == 18))
_IS_EDGE = (((_X == 0) | (_X == 18)) | ((_Y == 0) | (_Y == 18))) & ~_IS_CORNER
_CROSS_NEED = np.where(_IS_CORNER, 2, np.where(_IS_EDGE, 3, 4))
_DIAG_NEED = np.where(_IS_CORNER, 1, np.where(_IS_EDGE, 2, 3))


@functools.lru_cache(maxsize=None)
def _static(device: str):
    dev = torch.device(device)
    return (torch.as_tensor(NBR8, dtype=torch.long, device=dev),
            torch.as_tensor(_CROSS_NEED, device=dev),
            torch.as_tensor(_DIAG_NEED, device=dev))


def eye_heuristic(state: GoState, color=None) -> torch.Tensor:
    """bool[B, 361]: playing here would fill one's own heuristic eye
    (`options.rs:192-214`)."""
    nbr8, cross_need, diag_need = _static(str(state.stones.device))
    color = state.to_move if color is None else color
    col = torch.as_tensor(color, device=state.stones.device)
    col = col.reshape(-1, 1, 1) if col.dim() else col
    st8 = pad(state.stones, 3)[:, nbr8]                         # [B,361,8]
    own = st8 == col
    num_cross = own[:, :, :4].sum(-1)
    num_diag = own[:, :, 4:].sum(-1)
    return (num_cross >= cross_need) & (num_diag >= diag_need)


def scoring_mask(state: GoState) -> torch.Tensor:
    """bool[B, 362]: ScoringSearch candidates (pass always False)."""
    legal = legal_mask(state)
    _, eye_b = benson(state.stones, state.chain_id, BLACK)
    _, eye_w = benson(state.stones, state.chain_id, WHITE)
    moves = legal[:, :NN] & ~eye_b & ~eye_w & ~eye_heuristic(state)
    return torch.cat([moves, torch.zeros_like(moves[:, :1])], dim=1)


def standard_mask(state: GoState) -> torch.Tensor:
    """bool[B, 362]: StandardSearch candidates (legal moves + pass)."""
    return legal_mask(state)
