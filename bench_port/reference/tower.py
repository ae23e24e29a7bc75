"""dream-go's residual tower, its losses and its training step, in plain
float32 PyTorch (TF32 off).

The architecture of kblomdahl/dream-go's `contrib/trainer/dream_tf`
(`__main__.py:154-156`, `layers/residual_block.py`, `policy_head.py`,
`value_head.py`, `model_fn.py`): a 3x3 upsample conv, gated residual
blocks ``relu(alpha * conv(relu(conv(x))) + (1 - alpha) * x)``, a policy
head (3x3 conv to ``num_samples`` planes, dense to 362 logits, flattened
point-major), a value head (3x3 conv to 2 planes, dense to a tanh) and a
1x1 ownership conv.  The inference form has a bias on every conv (batch
norm folded in); the training form has none on the 3x3 convs, a batch
norm after each (scale 1, a trainable offset, epsilon 1e-3, the batch's
biased statistics) and a trainable ``alpha`` clipped to [0, 1].

Weights are a dict of tensors under the tower's parameter names
(``upsample.weight``, ``blocks.3.conv_1.weight``, ...; training form:
``upsample.conv.weight``, ``upsample.bn.bias``, ``blocks.3.alpha``, ...).
``quant``, where given, rounds every conv's and dense layer's input and
weight first: the lower-precision control.  Imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def float32():
    """TF32 off for convolutions and products, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _FP8(torch.autograd.Function):
    """Float8 training's rounding: e4m3 forward (one scale a tensor, its
    largest magnitude onto 448), the gradient that comes back e5m2 (onto
    57344)."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


class _OutFP8(torch.autograd.Function):
    """A product's output rounded e4m3 forward, as a float8 computation
    stores it; the gradient that comes back rounded e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 as float8 training rounds a product's
    operands: e4m3 forward, e5m2 for the gradient coming back."""
    return _FP8.apply(x)


def _id(x):
    return x


def _out(y, quant):
    """A product's output; under float8 rounded e4m3, and its incoming
    gradient rounded e5m2 before the backward products use it."""
    return y if quant is _id else _OutFP8.apply(y)


def _conv(x, w, b=None, quant=_id):
    return _out(F.conv2d(quant(x), quant(w), b, padding=w.shape[-1] // 2),
                quant)


def _dense(x, w, b, quant=_id):
    return _out(F.linear(quant(x), quant(w), b), quant)


def _heads(w, x, p_name, v_name, conv, quant):
    b = x.shape[0]
    p = conv(x, p_name)
    logits = _dense(p.permute(0, 2, 3, 1).reshape(b, -1),
                    w["policy_linear.weight"], w["policy_linear.bias"], quant)
    v = conv(x, v_name)
    ownership = torch.tanh(_conv(v, w["ownership_conv.weight"],
                                 w["ownership_conv.bias"], quant)
                           .reshape(b, 361))
    z = _dense(v.permute(0, 2, 3, 1).reshape(b, -1),
               w["value_linear.weight"], w["value_linear.bias"], quant)
    return logits, torch.tanh(z.reshape(b)), ownership


def forward(w: dict, x: torch.Tensor, num_blocks: int, quant=_id):
    """Inference form: ``x`` f32[B, 32, 19, 19] -> ``(logits[B, 362],
    value[B] in [-1, 1], ownership[B, 361])``."""
    w = {k: v.float() for k, v in w.items()}

    def conv(x, name):
        return F.relu(_conv(x, w[f"{name}.weight"], w[f"{name}.bias"],
                            quant))

    x = conv(x.float(), "upsample")
    for i in range(num_blocks):
        y = conv(x, f"blocks.{i}.conv_1")
        y = _conv(y, w[f"blocks.{i}.conv_2.weight"],
                  w[f"blocks.{i}.conv_2.bias"], quant)
        a = w[f"blocks.{i}.alpha"]
        x = F.relu(a * y + (1.0 - a) * x)
    return _heads(w, x, "policy_conv", "value_conv", conv, quant)


def predict(w: dict, x: torch.Tensor, num_blocks: int, quant=_id):
    """``(win rate [B] in [0, 1], policy softmax [B, 362])``."""
    logits, value, _ = forward(w, x, num_blocks, quant)
    return (value + 1.0) * 0.5, torch.softmax(logits, -1)


# ---------------------------------------------------------------------------
# training form


def _bn(y, offset):
    mean = y.mean((0, 2, 3), keepdim=True)
    var = ((y - mean) ** 2).mean((0, 2, 3), keepdim=True)
    return (y - mean) * torch.rsqrt(var + BN_EPS) + offset.reshape(1, -1, 1,
                                                                   1)


def train_forward(w: dict, x: torch.Tensor, num_blocks: int, quant=_id):
    """Training form on a batch (batch statistics): ``x`` f32[B, 32, 19,
    19] -> ``(logits, value, ownership)``."""

    def bnconv(x, name, relu=True):
        y = _bn(_conv(x, w[f"{name}.conv.weight"], None, quant),
                w[f"{name}.bn.bias"])
        return F.relu(y) if relu else y

    x = bnconv(x, "upsample")
    for i in range(num_blocks):
        y = bnconv(bnconv(x, f"blocks.{i}.conv_1"), f"blocks.{i}.conv_2",
                   relu=False)
        a = w[f"blocks.{i}.alpha"].clamp(0.0, 1.0)
        x = F.relu(a * y + (1.0 - a) * x)
    return _heads(w, x, "policy_conv", "value_conv", bnconv, quant)


def _smooth(labels, smoothing):
    return labels * (1.0 - smoothing) + smoothing / labels.shape[-1]


def loss(outputs, labels: dict, coefs: dict) -> torch.Tensor:
    """dream-go's loss (`model_fn.py:48-78`, `value_head.py:66-76`):
    ``policy_coef`` x softmax cross-entropy with label smoothing,
    ``value_coef`` x Huber (delta 1), ``ownership_coef`` x the per-point
    two-class cross-entropy with label smoothing where the game has
    ownership, averaged over the batch."""
    logits, value, ownership = outputs
    s = coefs["label_smoothing"]
    lp = -(_smooth(labels["policy"], s) * F.log_softmax(logits, -1)).sum(-1)
    err = (labels["value"] - value).abs()
    quad = err.clamp(max=1.0)
    lv = 0.5 * quad * quad + (err - quad)
    own = labels["ownership"]
    cat = _smooth(torch.stack([(1.0 + own) / 2.0, (1.0 - own) / 2.0], -1), s)
    logp = F.log_softmax(torch.stack([ownership, -ownership], -1), -1)
    lo = (-(cat * logp).sum(-1)).mean(-1) * labels["has_ownership"]
    return (coefs["policy_coef"] * lp + coefs["value_coef"] * lv
            + coefs["ownership_coef"] * lo).mean()


def is_kernel(name: str) -> bool:
    """Conv and dense kernels: the leaves the decoupled L2 shrinks."""
    return name.endswith(".weight")


def is_conv(name: str) -> bool:
    """Conv kernels: the leaves the max-norm projection bounds."""
    return name.endswith("conv.weight")


def train_steps(params: dict, batches, num_blocks: int, cfg: dict,
                quant=_id) -> dict:
    """``len(batches)`` steps of dream-go's trainer from ``params``: the
    loss, its gradients, the decoupled L2 (``w -= l2_coef * w`` on every
    kernel), Adam (``initial_lr``, betas (0.9, 0.999), eps 1e-8, PyTorch's
    bias correction) and the max-norm projection of every conv kernel's
    output rows onto norms in [0.001, 1/sqrt(outputs)].  ``batches`` are
    ``(x NCHW, labels)``.  Returns the losses, the first step's
    gradients and the parameters after the last step."""
    p = {k: v.detach().float().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = ADAM_BETAS
    losses, grad1 = [], None
    for t, (x, labels) in enumerate(batches, start=1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        value = loss(train_forward(leaves, x, num_blocks, quant), labels,
                     cfg)
        grads = torch.autograd.grad(value, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        losses.append(float(value.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in p:
                g = grads[k]
                if is_kernel(k):
                    p[k] = p[k] - cfg["l2_coef"] * p[k]
                m[k] = b1 * m[k] + (1.0 - b1) * g
                v2[k] = b2 * v2[k] + (1.0 - b2) * g * g
                denom = (v2[k].sqrt() / math.sqrt(1.0 - b2 ** t)) + ADAM_EPS
                p[k] = p[k] - cfg["initial_lr"] / (1.0 - b1 ** t) * m[k] \
                    / denom
            for k in p:
                if is_conv(k):
                    out = p[k].shape[0]
                    n = p[k].reshape(out, -1).norm(dim=1)
                    d = torch.minimum(n.clamp(min=0.001),
                                      n.new_tensor(out ** -0.5))
                    scale = torch.where(n > 0, d / n.clamp(min=1e-12), 0.0)
                    p[k] = p[k] * scale.reshape(out, 1, 1, 1)
    return {"losses": losses, "grad1": grad1, "params": p}
