"""Leela-zero teacher network: the weight file's reader and writer, and the
teacher's forward pass (port of `dream_go_tpu/models/leela_zero.py`).

A frozen leela-zero network from the public LZ text format gives the
(value, policy) labels of distillation over 18-plane LZ history features
(`model_fn.py:36-40` replaces the recorded value and policy labels).

Weight format (public leela-zero v1 and v2): a version line, then one line
of space-separated floats a tensor:

- input conv: weights [C,18,3,3] (OIHW flat), bias, bn_mean, bn_var
- per residual block, two convs x (weights, bias, bn_mean, bn_var)
- policy head: 1x1 conv (2 ch) + bn, then FC [2*361 -> 362] + bias
- value head: 1x1 conv (1 ch) + bn, then FC [361 -> 256] + bias,
  FC [256 -> 1] + bias

The block count comes from the line count and the width from the input
conv's bias.  Batch norm (no scale) is folded into the conv biases at load.
The file may be gzipped.  The weights dict holds float32 numpy arrays in
the JAX package's layout (HWIO kernels, dense kernels [in, out]), so
:func:`random_weights` gives both packages the same arrays from one seed.

The :class:`Teacher` computes in float32 with TF32 off (its convolutions
are cuDNN's on ``cuda``, as JAX's are XLA's, outside any kernel of this
port); it takes the JAX package's NHWC ``[B, 19, 19, 18]`` at its boundary
and computes in NCHW inside.
"""

from __future__ import annotations

import contextlib
import gzip

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-5


def _read_lines(path: str) -> list[np.ndarray]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        lines = [line.strip() for line in fh if line.strip()]
    version = lines[0]
    if version not in ("1", "2"):
        raise ValueError(f"unsupported leela-zero weights version {version!r}")
    # each number read as a float64 and rounded to float32 once, as
    # ``float(x)`` per number does
    return [np.asarray(line.split(), np.float64).astype(np.float32)
            for line in lines[1:]]


def load_weights(path: str) -> dict:
    """Parse an LZ weight file into a dict of folded numpy tensors."""
    t = _read_lines(path)
    channels = len(t[1])  # bias length of the input conv
    n_res_lines = len(t) - 4 - 6 - 8  # minus input conv, policy, value heads
    if n_res_lines % 8:
        raise ValueError("unexpected leela-zero weight layout")
    blocks = n_res_lines // 8

    def conv(i, out_c, in_c, k):
        w = t[i].reshape(out_c, in_c, k, k).transpose(2, 3, 1, 0)  # HWIO
        bias, mean, var = t[i + 1], t[i + 2], t[i + 3]
        std = np.sqrt(var + _EPS)
        return {"kernel": w / std, "bias": (bias - mean) / std}

    out = {"input": conv(0, channels, 18, 3), "blocks": []}
    i = 4
    for _ in range(blocks):
        out["blocks"].append((conv(i, channels, channels, 3),
                              conv(i + 4, channels, channels, 3)))
        i += 8
    out["policy_conv"] = conv(i, 2, channels, 1)
    out["policy_fc"] = {"kernel": t[i + 4].reshape(362, 2 * 361).T,
                        "bias": t[i + 5]}
    i += 6
    out["value_conv"] = conv(i, 1, channels, 1)
    out["value_fc1"] = {"kernel": t[i + 4].reshape(256, 361).T,
                        "bias": t[i + 5]}
    out["value_fc2"] = {"kernel": t[i + 6].reshape(1, 256).T,
                        "bias": t[i + 7]}
    out["channels"], out["num_blocks"] = channels, blocks
    return out


def save_weights(weights: dict, path: str):
    """Write the LZ text format; batch norm is written as the identity,
    since the tensors are stored folded."""
    lines = ["1"]
    # ``.6g`` of each float32 value (exact in a Python float)
    fmt = lambda a: " ".join(
        map("{:.6g}".format, np.asarray(a, np.float32).reshape(-1).tolist()))

    def conv(p, out_c):
        lines.append(fmt(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
        lines.append(fmt(p["bias"]))
        lines.append(" ".join("0" for _ in range(out_c)))            # mean
        lines.append(" ".join(f"{1.0 - _EPS}" for _ in range(out_c)))  # var

    c = weights["channels"]
    conv(weights["input"], c)
    for c1, c2 in weights["blocks"]:
        conv(c1, c)
        conv(c2, c)
    conv(weights["policy_conv"], 2)
    lines.append(fmt(np.asarray(weights["policy_fc"]["kernel"]).T))
    lines.append(fmt(weights["policy_fc"]["bias"]))
    conv(weights["value_conv"], 1)
    for name in ("value_fc1", "value_fc2"):
        lines.append(fmt(np.asarray(weights[name]["kernel"]).T))
        lines.append(fmt(weights[name]["bias"]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def random_weights(channels: int = 8, blocks: int = 1, seed: int = 0) -> dict:
    """A random LZ net from ``np.random.default_rng(seed)``, drawn in the
    JAX package's order."""
    rng = np.random.default_rng(seed)

    def conv(out_c, in_c, k):
        return {"kernel": rng.normal(0, 0.1, (k, k, in_c, out_c))
                .astype(np.float32),
                "bias": np.zeros(out_c, np.float32)}

    return {
        "input": conv(channels, 18, 3),
        "blocks": [(conv(channels, channels, 3), conv(channels, channels, 3))
                   for _ in range(blocks)],
        "policy_conv": conv(2, channels, 1),
        "policy_fc": {"kernel": rng.normal(0, 0.05, (2 * 361, 362))
                      .astype(np.float32),
                      "bias": np.zeros(362, np.float32)},
        "value_conv": conv(1, channels, 1),
        "value_fc1": {"kernel": rng.normal(0, 0.05, (361, 256))
                      .astype(np.float32),
                      "bias": np.zeros(256, np.float32)},
        "value_fc2": {"kernel": rng.normal(0, 0.05, (256, 1))
                      .astype(np.float32),
                      "bias": np.zeros(1, np.float32)},
        "channels": channels, "num_blocks": blocks,
    }


@contextlib.contextmanager
def _float32():
    """TF32 off for cuDNN's convolutions and cuBLAS's products, restored
    on exit (``torch.backends.cudnn.flags`` would also turn cuDNN off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Teacher(nn.Module):
    """The folded LZ net: ``teacher(lz_feats NHWC [B,19,19,18]) ->
    (value[B] in [-1, 1] for the player to move, policy[B, 362]
    softmax)``."""

    def __init__(self, weights: dict):
        super().__init__()
        frozen = lambda a: nn.Parameter(
            torch.tensor(np.asarray(a, np.float32)), requires_grad=False)
        conv = lambda p: (  # HWIO -> OIHW
            frozen(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            frozen(p["bias"]))
        dense = lambda p: (frozen(np.asarray(p["kernel"]).T),  # [out, in]
                           frozen(p["bias"]))
        self.convs = nn.ParameterList(
            [q for p in [weights["input"]]
             + [c for pair in weights["blocks"] for c in pair]
             + [weights["policy_conv"], weights["value_conv"]]
             for q in conv(p)])
        self.dense = nn.ParameterList(
            [q for name in ("policy_fc", "value_fc1", "value_fc2")
             for q in dense(weights[name])])
        self.num_blocks = len(weights["blocks"])

    def _conv(self, x, i):
        w, b = self.convs[2 * i], self.convs[2 * i + 1]
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    @torch.no_grad()
    def forward(self, lz_feats: torch.Tensor):
        with _float32():
            x = F.relu(self._conv(lz_feats.float().permute(0, 3, 1, 2), 0))
            for k in range(self.num_blocks):
                y = F.relu(self._conv(x, 1 + 2 * k))
                x = F.relu(x + self._conv(y, 2 + 2 * k))
            n = 1 + 2 * self.num_blocks
            # the heads flatten in NHWC order, as the JAX package does
            p = F.relu(self._conv(x, n)).permute(0, 2, 3, 1).flatten(1)
            policy = torch.softmax(F.linear(p, *self.dense[0:2]), dim=-1)
            v = F.relu(self._conv(x, n + 1)).flatten(1)
            v = F.relu(F.linear(v, *self.dense[2:4]))
            v = torch.tanh(F.linear(v, *self.dense[4:6]))
        return v.reshape(-1), policy


def teacher(weights: dict | str, device="cuda") -> Teacher:
    """The :class:`Teacher` of a weights dict or an LZ weight file, on
    ``device``."""
    if isinstance(weights, str):
        weights = load_weights(weights)
    return Teacher(weights).to(torch.device(device)).eval()
