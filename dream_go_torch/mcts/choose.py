"""Percentile-cutoff temperature sampling (port of
`dream_go_tpu/mcts/choose.py`, `choose.rs:26-120`): drop the low tail
until the kept entries cover ``1 - cutoff_percentile`` of the mass, raise
the kept weights to ``1/temperature``, and sample."""

from __future__ import annotations

import torch


def choose_weights(items: torch.Tensor, cutoff_percentile: float,
                   temperature: float) -> torch.Tensor:
    """[..., N] sampling weights after cutoff + temperature shaping."""
    x = torch.where(torch.isfinite(items), items, 0.0).float()
    x = torch.clamp(x, min=0.0)
    total = x.sum(-1, keepdim=True)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_desc, dim=-1)
    reached = csum >= (1.0 - cutoff_percentile) * total
    idx = torch.argmax(reached.to(torch.int8), dim=-1, keepdim=True)
    threshold = sorted_desc.gather(-1, idx)
    kept_total = csum.gather(-1, idx)
    keep = x >= threshold
    safe_total = torch.where(kept_total > 0, kept_total, 1.0)
    return torch.where(keep, (x / safe_total) ** (1.0 / temperature), 0.0)


def choose(generator: torch.Generator, items: torch.Tensor,
           cutoff_percentile: float = 0.5,
           temperature: float = 1.0) -> torch.Tensor:
    """Sample an index per row of ``items`` [B, N]; rows with no kept mass
    return N-1 (the pass slot, `choose(...).unwrap_or(361)`)."""
    w = choose_weights(items, cutoff_percentile, temperature)
    zero = w.sum(-1) <= 0
    safe = torch.where(zero[:, None], 1.0, w)
    idx = torch.multinomial(safe, 1, generator=generator)[:, 0]
    return torch.where(zero, items.shape[-1] - 1, idx)
