"""Training metrics: a JSONL stream, one object a step (port of
`dream_go_tpu/train/metrics.py`, in place of the reference's TensorBoard
summaries, `model_fn.py:112-183`), and per-module L2 norms."""

from __future__ import annotations

import json
import time

import torch


class MetricsWriter:
    """Appends ``{"step", "time", metric: value...}`` lines to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def write(self, step: int, metrics: dict):
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(record) + "\n")

    def close(self):
        self._fh.close()


def norm_summaries(named, grads: bool = False, prefix: str = "") -> dict:
    """L2 norm of each top-level module's tensors (`model_fn.py:112-125`),
    each residual block on its own: ``named`` is
    ``module.named_parameters()`` or any ``(name, tensor)`` pairs; with
    ``grads`` also their gradients' norms, as ``{prefix}grad_norm/...``."""
    sq: dict[str, torch.Tensor] = {}
    gsq: dict[str, torch.Tensor] = {}
    for name, t in named:
        parts = name.split(".")
        top = ".".join(parts[:2] if parts[0] == "blocks" else parts[:1])
        sq[top] = sq.get(top, 0.0) + t.detach().float().square().sum()
        if grads and t.grad is not None:
            gsq[top] = gsq.get(top, 0.0) + t.grad.float().square().sum()
    out = {f"{prefix}norm/{k}": v.sqrt() for k, v in sq.items()}
    out.update({f"{prefix}grad_norm/{k}": v.sqrt() for k, v in gsq.items()})
    return out
