"""Helpers shared with policy-only self-play (`dream_go_tpu/selfplay/
policy.py`): the random komi draw and the finished-board territory."""

from __future__ import annotations

import numpy as np
import torch

from ..go import benson as bn
from ..go.engine import GoState


def random_komi(n: int, seed: int = 0) -> np.ndarray:
    """Weighted random komi (`lib.rs:202-224`): 40% 7.5, 40% 6.5, 10% 0.5,
    10% uniform half-integer in [-7.5, 7.5]."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    out = np.full(n, 7.5, np.float32)
    out[u >= 0.4] = 6.5
    out[u >= 0.8] = 0.5
    rand_mask = u >= 0.9
    out[rand_mask] = rng.integers(-8, 8, rand_mask.sum()) + 0.5
    return out


def _final_territory(states: GoState) -> torch.Tensor:
    """int8[B, 361] EMPTY/BLACK/WHITE ownership of the finished boards."""
    return bn.stone_status(states.stones, states.chain_id, states.stones,
                           states.chain_id)[1]
