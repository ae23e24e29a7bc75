"""Inference tower: residual stack with policy / value / ownership heads.

Port of `dream_go_tpu/models/tower.py` in its folded form (BN folded into
the conv biases, as the weights JSON stores it).  The module runs NCHW;
the JAX package runs NHWC, and its heads flatten in HWC order
(`tower.py:107,129`), so the heads here permute to NHWC before their dense
layers.  Weights come from :func:`models.params.to_state_dict` or from
:func:`init_tower`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig


class ResidualBlock(nn.Module):
    """conv-relu, conv, then ``relu(alpha * y + (1 - alpha) * x)``
    (`residual_block.py:45-57`); ``alpha`` is stored clipped to [0, 1]."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv_2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.register_buffer("alpha", torch.tensor(0.5))

    def forward(self, x):
        y = F.relu(self.conv_1(x))
        y = self.conv_2(y)
        a = self.alpha.to(x.dtype)
        return F.relu(a * y + (1.0 - a) * x)


class Tower(nn.Module):
    """``forward(x[B, 32, 19, 19])`` -> ``(logits[B, 362], value[B],
    ownership[B, 361])``, outputs in float32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c, s = cfg.num_channels, cfg.num_samples
        self.cfg = cfg
        self.upsample = nn.Conv2d(cfg.num_features, c, 3, padding=1)
        self.blocks = nn.ModuleList(
            ResidualBlock(c) for _ in range(cfg.num_blocks))
        self.policy_conv = nn.Conv2d(c, s, 3, padding=1)
        self.policy_linear = nn.Linear(361 * s, 362)
        self.value_conv = nn.Conv2d(c, 2, 3, padding=1)
        self.ownership_conv = nn.Conv2d(2, 1, 1)
        self.value_linear = nn.Linear(722, 1)

    def forward(self, x):
        dtype = self.upsample.weight.dtype
        x = F.relu(self.upsample(x.to(dtype)))
        for block in self.blocks:
            x = block(x)
        b = x.shape[0]
        p = F.relu(self.policy_conv(x))
        logits = self.policy_linear(p.permute(0, 2, 3, 1).reshape(b, -1))
        v = F.relu(self.value_conv(x))
        ownership = torch.tanh(
            self.ownership_conv(v).reshape(b, 361).float())
        z = self.value_linear(v.permute(0, 2, 3, 1).reshape(b, -1))
        value = torch.tanh(z.reshape(b).float())
        return logits.float(), value, ownership


def init_tower(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype: str | None = None) -> Tower:
    """A seeded random tower (orthogonal kernels, zero biases, value bias
    -0.00502319782 as `value_head.py:62`, alpha 0.5) on ``device``, in
    ``dtype`` or else the compute dtype of ``cfg``.  Used when no weights
    file is given."""
    gen = torch.Generator().manual_seed(seed)
    model = Tower(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.orthogonal_(m.weight, generator=gen)
                m.bias.zero_()
        model.value_linear.bias.fill_(-0.00502319782)
    return place(model, cfg, device, dtype)


def from_state_dict(cfg: ModelConfig, sd: dict, device="cuda",
                    dtype: str | None = None) -> Tower:
    """A tower with the given ``state_dict`` on ``device``."""
    model = Tower(cfg)
    model.load_state_dict(sd)
    return place(model, cfg, device, dtype)


def place(model: Tower, cfg: ModelConfig, device, dtype=None) -> Tower:
    dt = getattr(torch, dtype or cfg.compute_dtype)
    return model.to(device=torch.device(device), dtype=dt).eval()
