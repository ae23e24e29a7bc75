"""Search, self-play and model configuration.

Port of `dream_go_tpu/config.py` (``Schedule``, ``SearchConfig``,
``SelfPlayConfig``, ``ModelConfig``, ``TrainConfig``, ``Config``), with the
fields the port's code reads (the JAX package's ``softmax_temperature``,
``vloss_cnt``, ``batch_size``, ``root_symmetries``, ``deterministic`` and
``resign_threshold`` are read by no code of the port).
Schedules are piecewise-linear tables over the total visit count, written
``"100=1.87,200=1.49"``;
:meth:`Schedule.at` evaluates one on a tensor with the same arithmetic as
``jnp.interp``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

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

    @staticmethod
    def constant(value: float) -> "Schedule":
        return Schedule(((0.0, float(value)),))

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


def _env_override(name: str, default: Any) -> Any:
    """``default``, or its value from ``DG_<NAME>``, else from the
    ``NAME=VALUE`` pairs of ``DG_OPTS`` (separated by ``;``), parsed as
    ``default``'s type (`config.rs`'s environment handling)."""
    opts = os.environ.get("DG_OPTS", "")
    value = None
    for pair in opts.split(";"):
        if "=" in pair:
            k, v = pair.split("=", 1)
            if k.strip().upper() == name.upper():
                value = v.strip()
    value = os.environ.get(f"DG_{name.upper()}", value)
    if value is None:
        return default
    if isinstance(default, Schedule):
        return Schedule.parse(value)
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes")
    return type(default)(value)


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
    max_nodes: int = 0                 # tree capacity; 0 = num_rollout + 8
    cutoff_percentile: float = 0.5
    adaptive: bool | None = None       # EARLY-C; None = on for cuda
    children_slots: int = 32           # sparse child slots per non-root node
    reuse_budget: bool = True          # reused visits count toward budget
    fused: bool | None = None          # leaf_step kernel; None = on for cuda
    ladder_features: bool = False      # planes 30/31 (the reference always
    #                                    computes them; a net's weights say
    #                                    whether it needs them, and the CLI
    #                                    follows that contract)
    ladders_exact: bool | None = None  # exact branching reader (the ladder
    #                                    kernel on cuda); False = greedy
    #                                    single line; None = auto (exact
    #                                    on cuda, greedy on the CPU).  One
    #                                    value drives the root eval and
    #                                    the leaves
    feature_kernel: bool = False       # liberties-after feature kernel for
    #                                    root evals and unfused leaves
    step_kernel: bool = False          # unfused leaves step through the
    #                                    env_step kernel (one-hot weights)
    feature_set: str = "v1"            # input plane family ("v1" / "v2")

    def resolved_max_nodes(self) -> int:
        return self.max_nodes if self.max_nodes > 0 else self.num_rollout + 8

    def resolve_auto(self, device) -> "SearchConfig":
        """Fill the ``None`` (auto) knobs for ``device``: the fused leaf
        kernel, EARLY-C termination and the exact ladder reader are on for
        ``cuda`` and off for the CPU.  An explicit ``True``/``False`` from
        the caller always wins.

        The V2 plane set is never fused: the leaf kernel computes the 32 V1
        planes, and the JAX package's fused path feeds those to the leaves
        whatever the set (`search.py:629-637`) while its roots take V2
        (`:591`), so it cannot run V2 fused either.  ``fused=None`` stays
        off with V2, and ``fused=True`` with V2 raises."""
        on_gpu = torch.device(device).type == "cuda"
        if self.feature_set != "v1" and self.fused:
            raise ValueError(f"the fused leaf kernel computes V1 planes; "
                             f"feature_set={self.feature_set!r} runs unfused")
        fused = (on_gpu and self.feature_set == "v1") if self.fused is None \
            else self.fused
        adaptive = on_gpu if self.adaptive is None else self.adaptive
        exact = on_gpu if self.ladders_exact is None else self.ladders_exact
        return dataclasses.replace(self, fused=fused, adaptive=adaptive,
                                   ladders_exact=exact)


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Self-play driver settings (`src/libdg_mcts/self_play.rs`)."""

    num_games: int = 1024
    num_rollout: int = 1600
    ex_it: bool = False
    ex_it_fraction: float = 0.05       # self_play.rs:315-319
    max_moves: int = 722
    temperature_moves: int = 8
    komi: float = 7.5
    random_komi: bool = False
    history_len: int = 64
    ladder_features: bool = False      # planes 30/31 in the RL loop's
    #                                    actor and example banks
    winrate_rollouts: bool = True
    winrate_momentum: float = 0.2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture (`contrib/trainer/dream_tf/__main__.py:154-156`)."""

    num_channels: int = 128
    num_blocks: int = 9
    num_samples: int = 8
    num_features: int = 32             # input planes (32 for v1, 18 for v2)
    feature_set: str = "v1"            # "v1" or "v2"
    ladder_features: bool = False      # does the net need planes 30/31?
    compute_dtype: str = "bfloat16"
    remat: bool = False                # recompute each residual block's
    #                                    activations in the backward pass


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings (`contrib/trainer/dream_tf/__main__.py:36-39,149`)."""

    batch_size: int = 2048
    max_examples: int = 524_288_000
    initial_lr: float = 3e-4
    warm_start_lr: float = 1e-4
    lr_decay: float = 3.0              # divide by 3 on plateau
    min_lr: float = 1e-5               # stop below this
    l2_coef: float = 1e-4              # decoupled L2 (model_fn.py:104)
    max_norm: bool = True              # conv column-norm clip (layers:33-50)
    policy_coef: float = 0.12          # model_fn.py:48-78
    value_coef: float = 1.0
    ownership_coef: float = 1.0
    label_smoothing: float = 0.2
    history_dropout: float = 0.05      # input_fn.py:124-138
    shuffle_buffer: int = 262_144
    plateau_window: int = 4096         # hooks/learning_rate.py:34
    checkpoint_every: int = 10_000


@dataclasses.dataclass(frozen=True)
class Config:
    """The four configurations together (`config.rs`'s globals)."""

    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    self_play: SelfPlayConfig = dataclasses.field(
        default_factory=SelfPlayConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @staticmethod
    def from_env() -> "Config":
        """The default configuration with the ``DG_OPTS`` / ``DG_*``
        overrides of the search's and self-play's knobs applied."""
        search = SearchConfig(
            num_rollout=_env_override("NUM_ROLLOUT", SearchConfig.num_rollout),
            uct_exp=_env_override("UCT_EXP",
                                  Schedule.parse("44=1.87,2536=1.48")),
            fpu_reduce=_env_override("FPU_REDUCE",
                                     Schedule.parse("44=0.67,3817=0.46")),
            critical_value=_env_override(
                "CRITICAL_VALUE", Schedule.parse("1=0.0,44=1.49,200=2.12")),
            dirichlet_noise=_env_override("DIRICHLET_NOISE",
                                          SearchConfig.dirichlet_noise),
            temperature=_env_override("TEMPERATURE",
                                      SearchConfig.temperature),
        )
        self_play = SelfPlayConfig(
            num_games=_env_override("NUM_GAMES", SelfPlayConfig.num_games),
            num_rollout=search.num_rollout,
        )
        return Config(search=search, self_play=self_play)
