"""Float rounding shared with the JAX package.

XLA contracts ``a * b + c`` in fused elementwise code into one fused
multiply-add, rounded once.  Where the port must reproduce the JAX
package's float32 results bit for bit (search scores, schedules), it
computes those expressions with :func:`fma`: the float32 product is exact
in float64, so the float64 sum rounded to float32 is the contracted
result.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with a single rounding."""
    return (a.double() * b.double() + c.double()).float()
