"""What the ranks of `test_torch_mesh.py` run, in processes spawned by
``dream_go_torch.parallel.distributed.spawn``.  It imports the port and
no JAX: one group of ranks runs every check and saves what it found with
``torch.save`` for the test to compare."""

from __future__ import annotations

import os

import numpy as np
import torch

from dream_go_torch.config import (ModelConfig, SearchConfig, SelfPlayConfig,
                                   TrainConfig)
from dream_go_torch.mcts.predictor import Predictor
from dream_go_torch.models import tower as TT
from dream_go_torch.parallel import distributed as D
from dream_go_torch.parallel import mesh as M
from dream_go_torch.selfplay import policy as TPO
from dream_go_torch.selfplay import search_play as TSP
from dream_go_torch.train import lr_schedule as TLR
from dream_go_torch.train import train_loop as TTL

SIZE = dict(num_channels=16, num_blocks=2, num_samples=2,
            compute_dtype="float32")
MCFG = ModelConfig(**SIZE)
BATCH = 16
TCFG = TrainConfig(batch_size=BATCH)
STEPS = 3


class FixedSource:
    """Fixed global batches, handed out in turn; ``rows`` keeps a rank's
    rows of each, as ``ExampleSource.batches`` does."""

    batch_size = BATCH

    def __init__(self, batches):
        self.todo = list(batches)

    def batches(self, n, rows=None):
        for _ in range(n):
            feats, labels = self.todo.pop(0)
            if rows is not None:
                feats = feats[rows]
                labels = {k: v[rows] for k, v in labels.items()}
            yield feats, labels


def trainer_from(sd: dict, dtype=torch.float32) -> TTL.Trainer:
    """A trainer holding the train-tower ``state_dict`` ``sd``, its
    parameters and statistics in ``dtype``."""
    model = TT.TrainTower(MCFG)
    model.load_state_dict(sd)
    model.to(dtype)
    return TTL.Trainer(MCFG, TCFG, model.train(),
                       TTL.make_optimizer(model, TCFG.initial_lr),
                       TLR.LearningRateScheduler(TCFG.initial_lr,
                                                 TCFG.lr_decay),
                       ema={k: p.detach().clone()
                            for k, p in model.named_parameters()})


def in_dtype(batches, dtype):
    return [(f.to(dtype), {k: v.to(dtype) for k, v in l.items()})
            for f, l in batches]


def train_record(trainer: TTL.Trainer, batches, metrics_path: str) -> dict:
    """``STEPS`` steps of ``fit``; the first step's gradients, then the
    metrics, parameters, running statistics and EMA after the last, all
    whole."""
    source = FixedSource(batches)
    trainer.fit(source, 1, metrics_path=metrics_path)
    grads = {k: trainer._whole(k, p.grad)
             for k, p in trainer.model.named_parameters()}
    trainer.fit(source, STEPS - 1, metrics_path=metrics_path)
    with open(metrics_path) as fh:
        metrics = fh.read()
    return {"grads": grads, "metrics": metrics, "state": trainer.state_dict(),
            "ema": {k: trainer._whole(k, v) for k, v in trainer.ema.items()}}


def hashed_predictor() -> Predictor:
    """A deterministic predictor whose outputs depend on each row's
    planes alone (no batch-sized reduction), with a policy spread over
    many moves, so that sampling picks among several."""
    w = torch.arange(1, 33, dtype=torch.float32) / 7.0

    def predict(feats):
        s = (feats.float() * w[:feats.shape[-1]]).sum(-1).reshape(-1, 361)
        pos = torch.arange(361, dtype=torch.float32) * 0.37
        logits = torch.cat([torch.sin(s * 1.3 + pos),
                            torch.full_like(s[:, :1], -2.0)], 1)
        value = torch.sigmoid(s[:, 40] * 0.1 - 0.2)
        return value, torch.softmax(logits * 2.0, -1)

    return Predictor(predict)


def peaked_predictor(w: np.ndarray, peak: np.ndarray) -> Predictor:
    """`_torch_bridge.peaked_predictor_torch` from its arrays."""
    w, peak = torch.from_numpy(w), torch.from_numpy(peak)

    def predict(feats):
        bits = (feats > 0.5).to(torch.int32)
        h = (bits * w).sum(dim=(1, 2, 3))
        a = torch.arange(362, dtype=torch.int32)
        rank = (h[:, None] * 31 + a[None, :] * 17) % 362
        value = ((h % 200) + 28).to(torch.float32) / 256.0
        return value, peak[rank.long()]

    return Predictor(predict)


POLICY_CFG = dict(num_games=5, max_moves=24, num_rollout=1, random_komi=True)
SEARCH_CFG = dict(num_games=3, max_moves=12, num_rollout=8)
#: search play held against JAX: greedy moves, no noise, fresh trees
JAX_SEARCH = dict(num_games=3, num_rollout=8, max_moves=6,
                  temperature_moves=0)


def policy_lines(mesh=None, seed=5) -> list[str]:
    return TPO.policy_self_play(TPO.PolicyPlayer(hashed_predictor()),
                                SelfPlayConfig(**POLICY_CFG), seed=seed,
                                device="cpu", mesh=mesh)


def search_lines(w, peak, mesh=None) -> list[str]:
    return TSP.search_self_play(peaked_predictor(w, peak),
                                SelfPlayConfig(**SEARCH_CFG), SearchConfig(),
                                seed=2, device="cpu", mesh=mesh)


def jax_search_lines(w, peak, mesh=None) -> list[str]:
    return TSP.search_self_play(
        peaked_predictor(w, peak), SelfPlayConfig(**JAX_SEARCH),
        SearchConfig(num_rollout=8, dirichlet_noise=0.0, fused=False,
                     adaptive=False),
        seed=0, tree_reuse=False, device="cpu", mesh=mesh)


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    D.initialize("cpu")
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    D.barrier()


def run_rank(rank: int, tmp: str, sd: dict, batches, w, peak) -> None:
    """Every check on one rank of a world of two; rank ``r`` saves
    ``tmp/rank{r}.pt``."""
    torch.set_num_threads(1)
    D.initialize("cpu")
    out = {}
    for dtype, model in ((torch.float64, 1), (torch.float64, 2),
                         (torch.float32, 1), (torch.float32, 2)):
        mesh = M.make_mesh(model=model)
        trainer = trainer_from(sd, dtype).shard_over(mesh)
        name = f"{str(dtype)[6:]}_model{model}"
        out[name] = train_record(trainer, in_dtype(batches, dtype),
                                 os.path.join(tmp, f"{name}_r{rank}.jsonl"))
        if dtype == torch.float32 and model == 2:
            # a checkpoint and a dump under the split head, then the
            # checkpoint restored onto the same mesh
            ckpt = os.path.join(tmp, "mesh_ckpt")
            trainer.save(ckpt)
            out["dump"] = trainer.dump_json()
            D.barrier()
            again = TTL.Trainer.restore(ckpt, TCFG, "cpu").shard_over(mesh)
            out["dump_after_restore"] = again.dump_json()
            out["local_policy_rows"] = tuple(
                again.model.policy_linear.weight.shape)
    mesh = M.make_mesh()
    out["policy_lines"] = policy_lines(mesh)
    out["search_lines"] = search_lines(w, peak, mesh)
    out["jax_lines"] = jax_search_lines(w, peak, mesh)
    out["continuous_lines"] = TSP.search_self_play_continuous(
        peaked_predictor(w, peak),
        SelfPlayConfig(num_games=4, max_moves=8, num_rollout=4),
        SearchConfig(), seed=1, batch=3, refill_every=2, device="cpu",
        mesh=mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    D.shutdown()
