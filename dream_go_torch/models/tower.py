"""Residual tower with policy / value / ownership heads.

Port of `dream_go_tpu/models/tower.py`: :class:`Tower` is its folded form
(BN folded into the conv biases, as the weights JSON stores it), for
inference; :class:`TrainTower` its training form, with the reference's
batch norm after every 3x3 conv.  The modules run NCHW; the JAX package
runs NHWC, and its heads flatten in HWC order (`tower.py:107,129`), so the
heads here permute to NHWC before their dense layers.  Weights come from
:func:`models.params.to_state_dict` (or ``from_train_tree`` for the
training form) or from :func:`init_tower` / :func:`init_train_tower`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
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


# ---------------------------------------------------------------------------
# the training form


class BatchNorm(nn.Module):
    """The reference's batch norm (`batch_norm.py:89-95`): scale fixed at
    1, a trainable offset ``bias``, epsilon 1e-3.  In training the batch's
    statistics normalise, and the running ``mean`` and ``var`` (float32)
    move 0.01 of the way towards them.  The running variance takes the
    biased variance the batch is normalised with, as flax's ``BatchNorm``
    does; ``F.batch_norm`` moves it towards the unbiased one, n/(n-1)
    times larger, so the update is corrected after the call.

    On a mesh (``group`` set by :meth:`TrainTower.shard_over`) the
    statistics are the whole batch's: the per-channel sum and sum of
    squares, in float32 at least, are summed over the data group by a
    differentiable all-reduce, and the variance is flax's ``E[x^2] -
    E[x]^2`` over the global count."""

    EPS = 1e-3
    MOMENTUM = 0.99

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        # the fixed scale, given: CUDA's batch-norm backward without a
        # weight returns no gradient for the offset
        self.register_buffer("scale", torch.ones(channels), persistent=False)
        self.group = None

    def forward(self, x, update: bool = True):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.EPS)
        if self.group is not None:
            return self._synced(x, update)
        # copies, which the backward pass may read after the update (and a
        # recomputation under remat saves the same tensors, then drops them)
        mean, var = self.mean.clone(), self.var.clone()
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True,
                         1.0 - self.MOMENTUM, self.EPS)
        if update:
            # var = m old + (1-m) u, u = b n/(n-1); want m old + (1-m) b
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.mean.copy_(mean)
                self.var.mul_(self.MOMENTUM / n).add_(var,
                                                      alpha=(n - 1) / n)
        return y

    def _synced(self, x, update: bool):
        from ..parallel import mesh as M

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        sums = M.all_reduce_sum(torch.stack(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]), self.group)
        n = x.numel() // x.shape[1] * dist.get_world_size(self.group)
        mean, mean2 = sums[0] / n, sums[1] / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (1, -1, 1, 1)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(
            var + self.EPS).reshape(shape) + self.bias.reshape(shape)
        if update:
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return y.to(x.dtype)


class BNConv(nn.Module):
    """3x3 conv without bias, batch norm, optional relu."""

    def __init__(self, cin: int, cout: int, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x, update: bool = True):
        y = self.bn(self.conv(x), update)
        return F.relu(y) if self.relu else y


class TrainBlock(nn.Module):
    """BN-conv-relu, BN-conv, then ``relu(alpha * y + (1 - alpha) * x)``
    with a trainable ``alpha`` clipped to [0, 1] in the forward."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_1 = BNConv(channels, channels)
        self.conv_2 = BNConv(channels, channels, relu=False)
        self.alpha = nn.Parameter(torch.tensor(0.5))

    def forward(self, x, update: bool = True):
        y = self.conv_2(self.conv_1(x, update), update)
        a = self.alpha.clamp(0.0, 1.0).to(y.dtype)
        return F.relu(a * y + (1.0 - a) * x.to(y.dtype))


def _remat(block: TrainBlock, x):
    """``block(x)`` whose activations are recomputed in the backward pass
    (``torch.utils.checkpoint``); the recomputation leaves the running
    statistics alone, as flax's ``nn.remat`` does, so they move once a
    step."""
    calls = []

    def run(x):
        calls.append(None)
        return block(x, update=len(calls) == 1)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class TrainTower(nn.Module):
    """The training form of :class:`Tower`, with the same names, the
    same ``forward`` and float32 outputs.  ``cfg.remat`` recomputes each
    residual block in the backward pass.  :meth:`shard_over` puts it on a
    mesh: synced batch norm, and with ``model > 1`` this rank's rows of
    the policy head's weight (its output columns)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c, s = cfg.num_channels, cfg.num_samples
        self.cfg = cfg
        self.upsample = BNConv(cfg.num_features, c)
        self.blocks = nn.ModuleList(TrainBlock(c) for _ in range(cfg.num_blocks))
        self.policy_conv = BNConv(c, s)
        self.policy_linear = nn.Linear(361 * s, 362)
        self.value_conv = BNConv(c, 2)
        self.ownership_conv = nn.Conv2d(2, 1, 1)
        self.value_linear = nn.Linear(722, 1)
        # (model group, first column, end column) of a split policy head
        self.policy_split = None

    def shard_over(self, mesh) -> None:
        """Sum the batch norms' statistics over ``mesh``'s data group, and
        with ``model > 1`` keep this rank's columns of the policy head
        (the bias stays whole and is added after the gather)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = mesh.data_group
        if mesh.model > 1:
            bounds = mesh.column_bounds(362)
            lo, hi = bounds[mesh.model_index], bounds[mesh.model_index + 1]
            w = self.policy_linear.weight
            self.policy_linear.weight = nn.Parameter(w.detach()[lo:hi].clone())
            self.policy_split = (mesh.model_group, lo, hi)

    def _policy_logits(self, flat):
        if self.policy_split is None:
            return self.policy_linear(flat)
        from ..parallel import mesh as M

        group, lo, hi = self.policy_split
        y = F.linear(M.copy_to_model(flat, group), self.policy_linear.weight)
        full = M.gather_columns(y, group, lo, hi, 362)
        return full + self.policy_linear.bias.to(full.dtype)

    def forward(self, x):
        x = self.upsample(x)
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = _remat(block, x) if remat else block(x)
        b = x.shape[0]
        p = self.policy_conv(x)
        logits = self._policy_logits(p.permute(0, 2, 3, 1).reshape(b, -1))
        v = self.value_conv(x)
        ownership = torch.tanh(
            self.ownership_conv(v).reshape(b, 361).float())
        z = self.value_linear(v.permute(0, 2, 3, 1).reshape(b, -1))
        value = torch.tanh(z.reshape(b).float())
        return logits.float(), value, ownership


def init_train_tower(cfg: ModelConfig, seed: int = 0,
                     device="cuda") -> TrainTower:
    """A seeded random :class:`TrainTower` in float32 on ``device``, in
    training mode: orthogonal kernels, zero biases and offsets, value
    bias -0.00502319782, alpha 0.5, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    model = TrainTower(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.orthogonal_(m.weight, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
        model.value_linear.bias.fill_(-0.00502319782)
    return model.to(torch.device(device)).train()
