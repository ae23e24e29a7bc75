"""Train and eval steps, the EMA, checkpoints and the driver loop (port of
`dream_go_tpu/train/train_loop.py`; the mesh and orbax are left out):

- Adam at the scheduler's learning rate, plus the reference's *decoupled*
  L2: conv and dense kernels lose ``1e-4 * w`` a step, not scaled by the
  learning rate (`model_fn.py:104`; kernels only, not biases, BN offsets
  or ``alpha``).  Adam's update does not depend on ``w``, so shrinking the
  kernels before the Adam step gives JAX's ``u - l2 * w``;
- the max-norm projection of every conv kernel after each step
  (`layers/__init__.py:33-50`);
- bf16 compute with float32 parameters on ``cuda`` (``torch.autocast``),
  the batch-norm statistics in float32; float32 on the CPU;
- the running statistics move in the same step (UPDATE_OPS parity);
- plateau LR scheduling and early stop
  (:class:`~.lr_schedule.LearningRateScheduler`);
- a float32 EMA of the parameters (decay 0.999, from a copy of the
  initial ones), which the weights dump takes (`moving_average.py`);
- checkpoints are one ``torch.save`` file holding the parameters and
  running statistics, the optimizer, the step, the EMA, the scheduler and
  the hyperparameters; they cannot read the JAX package's orbax
  checkpoints.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, TrainConfig
from ..models import params as MP
from ..models import tower as T
from . import losses
from .lr_schedule import LearningRateScheduler

#: the EMA's decay, rounded to float32 as JAX's ``jnp.float32(0.999)`` is
EMA_DECAY = float(np.float32(0.999))


def decay_params(model: nn.Module) -> list[torch.Tensor]:
    """Every conv and dense kernel, the 1x1 ownership conv's included (the
    reference's WEIGHTS collection)."""
    return [m.weight for m in model.modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


@torch.no_grad()
def normalize_conv_kernels(model: nn.Module) -> None:
    """Per-output-column max-norm projection of the conv kernels, in
    place: each output channel's kernel (a row over ``I*H*W`` of OIHW)
    rescaled so that its L2 norm lies in ``[0.001, 1/sqrt(out)]``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            out = w.shape[0]
            n = torch.linalg.vector_norm(w.reshape(out, -1), dim=1)
            top = torch.rsqrt(torch.tensor(out, dtype=torch.float32,
                                           device=w.device))
            d = torch.minimum(torch.clamp(n, min=0.001), top)
            scale = torch.where(n > 0.0, d / torch.clamp(n, min=1e-12), 0.0)
            w.mul_(scale.reshape(out, 1, 1, 1))


def policy_bias_from_lines(lines) -> np.ndarray:
    """Laplace-smoothed log move frequency of the games' moves, for the
    policy head's bias (the reference ships this table as
    `policy_head.py:56-121` ``policy_offset_op``)."""
    from .pipeline import parse_game

    counts = np.ones(362, np.float64)
    for line in lines:
        game = parse_game(line)
        if game is not None:
            np.add.at(counts, np.minimum(game.moves, 361), 1.0)
    return np.log(counts / counts.sum()).astype(np.float32)


@torch.no_grad()
def set_policy_bias(model: T.TrainTower, bias) -> None:
    model.policy_linear.bias.copy_(torch.as_tensor(bias, dtype=torch.float32))


def _autocast(cfg: ModelConfig, device: torch.device):
    """bf16 (the config's compute dtype) on ``cuda``, float32 elsewhere."""
    on = device.type == "cuda" and cfg.compute_dtype != "float32"
    return torch.autocast(device.type, dtype=getattr(torch, cfg.compute_dtype),
                          enabled=on)


def train_step(model: T.TrainTower, optimizer: torch.optim.Optimizer,
               train_cfg: TrainConfig, feats, labels, learning_rate: float):
    """One optimization step on ``feats`` (NHWC) and ``labels``; returns the
    metrics (0-d tensors)."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = learning_rate
    with _autocast(model.cfg, feats.device):
        out = model(feats.permute(0, 3, 1, 2))
    loss, metrics = losses.total_loss(out, labels, train_cfg)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        kernels = decay_params(model)
        torch._foreach_add_(kernels, kernels, alpha=-train_cfg.l2_coef)
    optimizer.step()
    if train_cfg.max_norm:
        normalize_conv_kernels(model)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: T.TrainTower, train_cfg: TrainConfig, feats, labels):
    """The metrics of ``feats`` with the running statistics."""
    model.eval()
    with _autocast(model.cfg, feats.device):
        out = model(feats.permute(0, 3, 1, 2))
    return losses.total_loss(out, labels, train_cfg)[1]


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults; the decoupled L2 is applied apart."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


@dataclasses.dataclass
class Trainer:
    """Host-side training driver (the ``--start`` / ``--resume``
    procedures).  ``ema`` holds a float32 copy of each parameter, by
    name."""

    model_cfg: ModelConfig
    train_cfg: TrainConfig
    model: T.TrainTower
    optimizer: torch.optim.Optimizer
    scheduler: LearningRateScheduler
    step: int = 0
    ema: dict | None = None
    ema_decay: float = EMA_DECAY

    @staticmethod
    def create(model_cfg: ModelConfig, train_cfg: TrainConfig,
               seed: int = 0, warm_start: bool = False, policy_bias=None,
               device="cuda") -> "Trainer":
        lr = train_cfg.warm_start_lr if warm_start else train_cfg.initial_lr
        model = T.init_train_tower(model_cfg, seed, device)
        normalize_conv_kernels(model)
        if policy_bias is not None:
            set_policy_bias(model, policy_bias)
        return Trainer(model_cfg, train_cfg, model, make_optimizer(model, lr),
                       LearningRateScheduler(lr, train_cfg.lr_decay),
                       ema={k: p.detach().float().clone()
                            for k, p in model.named_parameters()})

    @torch.no_grad()
    def _ema_update(self):
        names = list(self.ema)
        params = dict(self.model.named_parameters())
        ema = [self.ema[k] for k in names]
        # the complement in float32, as JAX's ``1.0 - decay`` is
        rate = float(np.float32(1.0) - np.float32(self.ema_decay))
        torch._foreach_mul_(ema, self.ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [params[k].float() for k in names], rate))

    def fit(self, source, num_steps: int, log_every: int = 100,
            log_fn=print, metrics_path: str | None = None) -> dict:
        from .metrics import MetricsWriter

        writer = MetricsWriter(metrics_path) if metrics_path else None
        last_metrics = {}
        try:
            for i, (feats, labels) in enumerate(source.batches(num_steps)):
                lr = self.scheduler.learning_rate
                metrics = train_step(self.model, self.optimizer,
                                     self.train_cfg, feats, labels, lr)
                self.step += 1
                if self.ema is not None:
                    self._ema_update()
                last_metrics = {k: float(v) for k, v in metrics.items()}
                loss = last_metrics["loss"]
                self.scheduler.update(loss)
                last_metrics["learning_rate"] = lr
                last_metrics["lr_slope"] = self.scheduler.slope
                last_metrics["lr_p_decreasing"] = self.scheduler.p_decreasing
                if writer:
                    writer.write(self.step, last_metrics)
                if log_every and (i + 1) % log_every == 0:
                    log_fn(f"step {self.step} loss {loss:.4f} "
                           f"lr {self.scheduler.learning_rate:.2e} "
                           f"top1 {last_metrics['policy_top1']:.3f}")
                if self.scheduler.should_stop:
                    break
        finally:
            if writer:
                writer.close()
        return last_metrics

    def evaluate(self, source, num_batches: int) -> dict:
        agg: dict[str, float] = {}
        n = 0
        for feats, labels in source.batches(num_batches):
            for k, v in eval_step(self.model, self.train_cfg, feats,
                                  labels).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def dump_params(self) -> dict:
        """The tower's ``state_dict`` for the weights dump: the EMA's
        parameters where tracked, the running statistics."""
        sd = dict(self.model.state_dict())
        if self.ema is not None:
            sd.update(self.ema)
        return sd

    def dump_json(self) -> str:
        return MP.dump_json(self.model_cfg,
                            *MP.to_train_tree(self.model_cfg,
                                              self.dump_params()))

    # -- checkpointing ------------------------------------------------------

    def save(self, path: str):
        """Write the checkpoint to ``path`` (a file; its directory is
        made), through a temporary file renamed into place."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sched = self.scheduler.state_dict()
        sched["losses"] = torch.from_numpy(np.asarray(sched["losses"]))
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "ema": self.ema,
            "scheduler": sched,
            "hyper": {
                "num_channels": self.model_cfg.num_channels,
                "num_blocks": self.model_cfg.num_blocks,
                "num_samples": self.model_cfg.num_samples,
                "ladder_features": int(self.model_cfg.ladder_features),
            },
        }, tmp)
        os.replace(tmp, path)

    @staticmethod
    def restore(path: str, train_cfg: TrainConfig | None = None,
                device="cuda") -> "Trainer":
        device = torch.device(device)
        data = torch.load(os.path.abspath(path), map_location=device,
                          weights_only=True)
        hyper = data["hyper"]
        model_cfg = ModelConfig(
            num_channels=int(hyper["num_channels"]),
            num_blocks=int(hyper["num_blocks"]),
            num_samples=int(hyper["num_samples"]),
            ladder_features=bool(int(hyper["ladder_features"])))
        train_cfg = train_cfg or TrainConfig()
        model = T.TrainTower(model_cfg).to(device)
        model.load_state_dict(data["model"])
        optimizer = make_optimizer(model, train_cfg.initial_lr)
        optimizer.load_state_dict(data["optimizer"])
        scheduler = LearningRateScheduler(train_cfg.initial_lr,
                                          train_cfg.lr_decay)
        sched = dict(data["scheduler"])
        sched["losses"] = sched["losses"].cpu().numpy()
        scheduler.load_state_dict(sched)
        return Trainer(model_cfg, train_cfg, model.train(), optimizer,
                       scheduler, step=int(data["step"]), ema=data["ema"])
