"""The leaf-evaluator seam (port of `dream_go_tpu/mcts/predictor.py`).

A predictor maps V1 features to ``(value[B], policy[B, 362])``: ``value``
the to-move win rate in [0, 1] and ``policy`` a softmax distribution.
``predictor(feats)`` takes the JAX package's NHWC layout ``[B, 19, 19,
32]``; ``predictor.planes(x)`` takes plane-major ``[B, 32, 19, 19]``,
which is what the fused leaf kernel writes, so the search feeds the tower
without a transpose.
"""

from __future__ import annotations

import torch

from ..models.tower import Tower


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
