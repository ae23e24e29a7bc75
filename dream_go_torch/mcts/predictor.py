"""The leaf-evaluator seam (port of `dream_go_tpu/mcts/predictor.py`).

A predictor maps V1 features to ``(value[B], policy[B, 362])``: ``value``
the to-move win rate in [0, 1] and ``policy`` a softmax distribution.
``predictor(feats)`` takes the JAX package's NHWC layout ``[B, 19, 19,
32]``; ``predictor.planes(x)`` takes plane-major ``[B, 32, 19, 19]``,
which is what the fused leaf kernel writes, so the search feeds the tower
without a transpose.  :func:`symmetrize` averages a predictor over the
eight board symmetries.
"""

from __future__ import annotations

import torch

from ..go.topology import SYM_POLICY, SYM_POLICY_INV
from ..models.tower import Tower
from ..utils import spans


class Predictor:
    """Wraps an NHWC function ``feats -> (value, policy)``."""

    def __init__(self, fn=None):
        self.fn = fn

    def __call__(self, feats: torch.Tensor):
        return self.fn(feats)

    def planes(self, x: torch.Tensor):
        return self(x.permute(0, 2, 3, 1))


class NetPredictor(Predictor):
    """Tower weights as a predictor (`predictors/nn.rs:47-109`): the
    softmax temperature divides the logits, and the tanh value in [-1, 1]
    becomes a win rate ``(v + 1) / 2``."""

    def __init__(self, model: Tower, softmax_temp: float = 1.0):
        super().__init__()
        self.model = model
        self.softmax_temp = softmax_temp

    def __call__(self, feats):
        return self.planes(feats.permute(0, 3, 1, 2))

    @spans.spanned("search.net")
    @torch.no_grad()
    def planes(self, x):
        logits, value, _ = self.model(x)
        policy = torch.softmax(logits / self.softmax_temp, dim=-1)
        return (value + 1.0) * 0.5, policy


def net_predictor(model: Tower, *, softmax_temp: float = 1.0) -> NetPredictor:
    return NetPredictor(model, softmax_temp)


def fake_predictor(point: int, value: float = 0.6) -> Predictor:
    """Deterministic single-point policy (`predictors/fake.rs`)."""
    def predict(feats):
        b = feats.shape[0]
        policy = torch.zeros(b, 362, device=feats.device)
        policy[:, point] = 1.0
        return torch.full((b,), value, device=feats.device), policy

    return Predictor(predict)


def random_predictor(noise: float = 0.0,
                     generator: torch.Generator | None = None) -> Predictor:
    """Uniform policy (`predictors/random.rs`); with ``noise``, jittered by
    draws from ``generator``."""
    def predict(feats):
        b = feats.shape[0]
        policy = torch.full((b, 362), 1.0 / 362.0, device=feats.device)
        if noise:
            policy = policy + noise * torch.rand(
                b, 362, generator=generator, device=feats.device)
            policy = policy / policy.sum(-1, keepdim=True)
        return torch.full((b,), 0.5, device=feats.device), policy

    return Predictor(predict)


def nan_predictor() -> Predictor:
    """All-NaN outputs, for the search's numerical-fault path
    (`predictors/nan.rs`)."""
    def predict(feats):
        b = feats.shape[0]
        nan = float("nan")
        return (torch.full((b,), nan, device=feats.device),
                torch.full((b, 362), nan, device=feats.device))

    return Predictor(predict)


def symmetrize(predict: Predictor) -> Predictor:
    """8-symmetry averaged evaluation (`lib.rs:83-130` full_forward): each
    D8 transform of the NHWC features, one predictor call on the 8B batch,
    the policies mapped back through the inverse transforms, then value
    and policy averaged over the eight."""
    def predict_sym(feats):
        b, c = feats.shape[0], feats.shape[-1]
        sym = torch.as_tensor(SYM_POLICY[:, :361], dtype=torch.long,
                              device=feats.device)
        inv = torch.as_tensor(SYM_POLICY_INV, dtype=torch.long,
                              device=feats.device)
        flat = feats.reshape(b, 361, c)
        stacked = flat[:, sym].transpose(0, 1).reshape(8 * b, 19, 19, c)
        value, policy = predict(stacked)
        policy = policy.reshape(8, b, 362).gather(
            2, inv[:, None, :].expand(8, b, 362))
        return value.reshape(8, b).mean(0), policy.mean(0)

    return Predictor(predict_sym)
