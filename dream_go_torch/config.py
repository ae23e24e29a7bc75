"""Search, self-play and model configuration.

Port of `dream_go_tpu/config.py` (``Schedule``, ``SearchConfig``,
``SelfPlayConfig``, ``ModelConfig``), with the fields the port's code
reads; the others (ladder readers, ex-it, the opt-in TPU kernels, ...)
come with the code that reads them.  Schedules are piecewise-linear
tables over the total visit count, written ``"100=1.87,200=1.49"``;
:meth:`Schedule.at` evaluates one on a tensor with the same arithmetic as
``jnp.interp``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils.numerics import fma


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Piecewise-linear schedule keyed by total visit count, clamped at the
    ends (`config.rs:297-313` ``get_intp_value``)."""

    knots: tuple[tuple[float, float], ...]  # (visits, value), ascending

    @staticmethod
    def parse(text: str) -> "Schedule":
        knots = []
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=")
                knots.append((float(k), float(v)))
            else:
                knots.append((0.0, float(part)))
        knots.sort()
        return Schedule(tuple(knots))

    def at(self, visits: torch.Tensor) -> torch.Tensor:
        """Interpolated float32 value at each visit count: ``jnp.interp``'s
        ``fp[i-1] + (x - xp[i-1]) / dx * df``, with the multiply-add
        rounded once as XLA computes it."""
        x = visits.to(torch.float32)
        xp = torch.tensor([k for k, _ in self.knots], dtype=torch.float32,
                          device=x.device)
        fp = torch.tensor([v for _, v in self.knots], dtype=torch.float32,
                          device=x.device)
        if len(self.knots) == 1:
            return torch.full_like(x, float(fp[0]))
        i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                        len(self.knots) - 1)
        df = fp[i] - fp[i - 1]
        dx = xp[i] - xp[i - 1]
        delta = x - xp[i - 1]
        eps = float(np.spacing(np.finfo(np.float32).eps))
        dx0 = dx.abs() <= eps
        f = torch.where(dx0, fp[i - 1],
                        fma(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1]))
        f = torch.where(x < xp[0], fp[0], f)
        return torch.where(x > xp[-1], fp[-1], f)

    def at_host(self, visits: float) -> float:
        xs = np.asarray([k for k, _ in self.knots])
        ys = np.asarray([v for _, v in self.knots])
        return float(np.interp(visits, xs, ys))


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """MCTS hyperparameters (defaults match `src/libdg_utils/config.rs`)."""

    num_rollout: int = 1600
    uct_exp: Schedule = dataclasses.field(
        default_factory=lambda: Schedule.parse("44=1.87,2536=1.48"))
    fpu_reduce: Schedule = dataclasses.field(
        default_factory=lambda: Schedule.parse("44=0.67,3817=0.46"))
    critical_value: Schedule = dataclasses.field(
        default_factory=lambda: Schedule.parse("1=0.0,44=1.49,200=2.12"))
    dirichlet_noise: float = 0.25
    dirichlet_alpha: float = 0.03
    temperature: float = 0.7
    cutoff_percentile: float = 0.5
    adaptive: bool | None = None       # EARLY-C; None = on for cuda
    children_slots: int = 32           # sparse child slots per non-root node
    reuse_budget: bool = True          # reused visits count toward budget
    fused: bool | None = None          # leaf_step kernel; None = on for cuda

    def resolve_auto(self, device) -> "SearchConfig":
        """Fill the ``None`` (auto) knobs for ``device``: the fused leaf
        kernel and EARLY-C termination are on for ``cuda`` and off for the
        CPU.  An explicit ``True``/``False`` from the caller always wins."""
        on_gpu = torch.device(device).type == "cuda"
        fused = on_gpu if self.fused is None else self.fused
        adaptive = on_gpu if self.adaptive is None else self.adaptive
        return dataclasses.replace(self, fused=fused, adaptive=adaptive)


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Self-play driver settings (`src/libdg_mcts/self_play.rs`)."""

    num_games: int = 1024
    num_rollout: int = 1600
    max_moves: int = 722
    temperature_moves: int = 8
    komi: float = 7.5
    random_komi: bool = False
    history_len: int = 64
    winrate_rollouts: bool = True
    winrate_momentum: float = 0.2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture (`contrib/trainer/dream_tf/__main__.py:154-156`)."""

    num_channels: int = 128
    num_blocks: int = 9
    num_samples: int = 8
    num_features: int = 32             # V1 planes
    ladder_features: bool = False      # does the net need planes 30/31?
    compute_dtype: str = "bfloat16"
