"""Train and eval steps, the EMA, checkpoints and the driver loop (port of
`dream_go_tpu/train/train_loop.py`; orbax is left out):

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
  checkpoints;
- on a mesh (:meth:`Trainer.shard_over`, JAX's ``shard_over``) each rank
  trains on its rows of every global batch: the batch norms' statistics
  and, after the backward pass, the gradients (one flattened all-reduce)
  are the whole batch's, and the metrics that feed the scheduler are
  summed over the data group, so every rank takes the same steps.  With
  ``model > 1`` the policy head's weight, its Adam moments and its EMA
  are split by output column; checkpoints and dumps gather them whole,
  rank 0 writes, and a checkpoint restores on any mesh or none.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
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


def _metrics(out, labels, train_cfg: TrainConfig, mesh=None):
    """``(loss, metrics)`` of a batch; on a mesh the metrics (detached)
    are the global batch's: means averaged over the data group, the
    ownership accuracy from its summed counts."""
    loss, metrics = losses.total_loss(out, labels, train_cfg)
    if mesh is None:
        return loss, metrics
    names = [k for k in metrics if k != "ownership_accuracy"]
    hits, counted = losses.ownership_counts(out[2].detach(), labels)
    vals = torch.stack([metrics[k].detach().float() for k in names]
                       + [hits.float(), counted.float()])
    dist.all_reduce(vals, group=mesh.data_group)
    out = {k: vals[i] / mesh.data for i, k in enumerate(names)}
    out["ownership_accuracy"] = vals[-2] / torch.clamp(vals[-1], min=1.0)
    return loss, {k: out[k] for k in metrics}


@torch.no_grad()
def sync_gradients(model: nn.Module, mesh) -> None:
    """Average every parameter's gradient over the data group, as one
    flattened all-reduce."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in model.parameters()]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))


def train_step(model: T.TrainTower, optimizer: torch.optim.Optimizer,
               train_cfg: TrainConfig, feats, labels, learning_rate: float,
               mesh=None):
    """One optimization step on ``feats`` (NHWC) and ``labels``, this
    rank's rows of the global batch on a ``mesh``; returns the metrics
    (0-d tensors, the global batch's on a mesh)."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = learning_rate
    with _autocast(model.cfg, feats.device):
        out = model(feats.permute(0, 3, 1, 2))
    loss, metrics = _metrics(out, labels, train_cfg, mesh)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        sync_gradients(model, mesh)
    with torch.no_grad():
        kernels = decay_params(model)
        torch._foreach_add_(kernels, kernels, alpha=-train_cfg.l2_coef)
    optimizer.step()
    if train_cfg.max_norm:
        normalize_conv_kernels(model)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: T.TrainTower, train_cfg: TrainConfig, feats, labels,
              mesh=None):
    """The metrics of ``feats`` with the running statistics."""
    model.eval()
    with _autocast(model.cfg, feats.device):
        out = model(feats.permute(0, 3, 1, 2))
    return _metrics(out, labels, train_cfg, mesh)[1]


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults; the decoupled L2 is applied apart."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _own_state(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's ``state_dict`` with per-parameter state dicts of
    its own (``state_dict`` shares them with the live optimizer)."""
    sd = optimizer.state_dict()
    sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
    return sd


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
    mesh: object = None

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

    def shard_over(self, mesh) -> "Trainer":
        """Train on ``mesh`` (:mod:`..parallel.mesh`): synced batch norm,
        and with ``model > 1`` this rank's columns of the policy head,
        of its Adam moments and of its EMA."""
        from ..parallel import mesh as M

        names = [k for k, _ in self.model.named_parameters()]
        opt_sd = _own_state(self.optimizer)
        self.model.shard_over(mesh)
        if self.model.policy_split is not None:
            _, lo, hi = self.model.policy_split
            for name, dim in M.param_sharding(mesh, names).items():
                if dim is None:
                    continue
                state = opt_sd["state"].get(names.index(name), {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in state:
                        state[key] = state[key][lo:hi].clone()
                if self.ema is not None:
                    self.ema[name] = self.ema[name][lo:hi].clone()
            self.optimizer = make_optimizer(self.model, 0.0)
            self.optimizer.load_state_dict(opt_sd)
        self.mesh = mesh
        return self

    def _whole(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's share of parameter ``name``, or a tensor of
        its shape) gathered whole over the model group."""
        from ..parallel import mesh as M

        split = self.model.policy_split
        if split is None or name not in M.MODEL_SPLIT:
            return x
        group, lo, _ = split
        return M.gather_rows(x.detach(), group, lo, 362)

    def state_dict(self) -> dict:
        """The tower's ``state_dict`` with every parameter whole (a
        collective on a mesh split over ``model``: every rank calls
        it)."""
        return {k: self._whole(k, v)
                for k, v in self.model.state_dict().items()}

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
            for i, (feats, labels) in enumerate(self._batches(source,
                                                              num_steps)):
                lr = self.scheduler.learning_rate
                metrics = train_step(self.model, self.optimizer,
                                     self.train_cfg, feats, labels, lr,
                                     self.mesh)
                self.step += 1
                if self.ema is not None:
                    self._ema_update()
                # one copy to the host (a synchronisation) for them all
                last_metrics = dict(zip(metrics, torch.stack(
                    list(metrics.values())).tolist()))
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

    def _batches(self, source, num_batches: int):
        """The source's batches, this rank's rows of each on a mesh."""
        if self.mesh is None:
            return source.batches(num_batches)
        return source.batches(
            num_batches, rows=self.mesh.local_rows(source.batch_size))

    def evaluate(self, source, num_batches: int) -> dict:
        agg: dict[str, float] = {}
        n = 0
        for feats, labels in self._batches(source, num_batches):
            for k, v in eval_step(self.model, self.train_cfg, feats,
                                  labels, self.mesh).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def dump_params(self) -> dict:
        """The tower's ``state_dict`` for the weights dump, whole: the
        EMA's parameters where tracked, the running statistics."""
        sd = self.state_dict()
        if self.ema is not None:
            sd.update({k: self._whole(k, v) for k, v in self.ema.items()})
        return sd

    def dump_json(self) -> str:
        return MP.dump_json(self.model_cfg,
                            *MP.to_train_tree(self.model_cfg,
                                              self.dump_params()))

    # -- checkpointing ------------------------------------------------------

    def save(self, path: str):
        """Write the checkpoint to ``path`` (a file; its directory is
        made), through a temporary file renamed into place.  On a mesh
        every rank calls it and rank 0 writes the whole tensors."""
        from ..parallel import distributed as D

        names = [k for k, _ in self.model.named_parameters()]
        opt_sd = _own_state(self.optimizer)
        for i, name in enumerate(names):
            for key, v in opt_sd["state"].get(i, {}).items():
                if key != "step":
                    opt_sd["state"][i][key] = self._whole(name, v)
        model_sd = self.state_dict()
        ema = None if self.ema is None else {
            k: self._whole(k, v) for k, v in self.ema.items()}
        if not D.is_writer():
            return
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sched = self.scheduler.state_dict()
        sched["losses"] = torch.from_numpy(np.asarray(sched["losses"]))
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "model": model_sd,
            "optimizer": opt_sd,
            "step": self.step,
            "ema": ema,
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
