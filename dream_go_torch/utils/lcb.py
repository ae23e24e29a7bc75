"""Lower confidence bound for final move selection (`lcb.rs:28-36`)."""

from __future__ import annotations

import torch


def normal_lcb(p_hat, p_std, n, z=1.0):
    """``p_hat - z * p_std / sqrt(n)``; ``n`` may be a tensor of counts."""
    n = torch.clamp(n, min=1)
    return p_hat - z * p_std / torch.sqrt(n.to(torch.float32))
