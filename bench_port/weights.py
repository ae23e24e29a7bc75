"""Seeded random weights, made on the device in a few large draws.

The benchmark makes every weight it runs and hands the same tensors to the
program and to the reference.  Kernels are drawn N(0, 2 / fan-in) (He),
biases and batch-norm offsets N(0, 0.05^2), the residual gates ``alpha``
uniform in [0.3, 0.7]; no trained net at the published widths is in the
repository (the configurations list this under ``assumed``).
"""

from __future__ import annotations

import math

import torch


def dg_shapes(cfg: dict, train: bool) -> dict:
    """Parameter names and shapes of the dream-go tower (inference form, or
    the training form's trainable leaves)."""
    c, s, f = cfg["num_channels"], cfg["num_samples"], cfg["num_features"]
    shapes = {}

    def conv(name, cin, cout, k=3):
        if train:
            shapes[f"{name}.conv.weight"] = (cout, cin, k, k)
            shapes[f"{name}.bn.bias"] = (cout,)
        else:
            shapes[f"{name}.weight"] = (cout, cin, k, k)
            shapes[f"{name}.bias"] = (cout,)

    conv("upsample", f, c)
    for i in range(cfg["num_blocks"]):
        conv(f"blocks.{i}.conv_1", c, c)
        conv(f"blocks.{i}.conv_2", c, c)
        shapes[f"blocks.{i}.alpha"] = ()
    conv("policy_conv", c, s)
    shapes["policy_linear.weight"] = (362, 361 * s)
    shapes["policy_linear.bias"] = (362,)
    conv("value_conv", c, 2)
    shapes["ownership_conv.weight"] = (1, 2, 1, 1)
    shapes["ownership_conv.bias"] = (1,)
    shapes["value_linear.weight"] = (1, 722)
    shapes["value_linear.bias"] = (1,)
    return shapes


def make(shapes: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Tensors of ``shapes`` from one normal draw and one uniform draw of
    a generator on ``device`` seeded by ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    sizes = [math.prod(s) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=dev)
    uniform = torch.rand(len(shapes), generator=gen, device=dev)
    out, at = {}, 0
    for i, ((name, shape), n) in enumerate(zip(shapes.items(), sizes)):
        x = normal[at:at + n].reshape(shape)
        at += n
        if name.endswith("alpha"):
            x = 0.3 + 0.4 * uniform[i]
        elif len(shape) >= 2:
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        else:
            x = x * 0.05
        out[name] = x.to(dtype).contiguous()
    return out

