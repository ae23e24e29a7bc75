"""Leela-zero distillation: the value and policy labels replaced by a
teacher's outputs (port of `dream_go_tpu/train/distill.py`).

Parity with `contrib/trainer/dream_tf/model_fn.py:36-40` (``--lz-weights``):
given a leela-zero weight file, the trainer learns the teacher's value and
policy over LZ history features instead of the recorded labels, and no
ownership (the teacher has no ownership head).
"""

from __future__ import annotations

import torch

from ..models import leela_zero
from .pipeline import ExampleSource


class DistillationSource:
    """Wraps an :class:`ExampleSource` built with ``lz_history=True``; the
    teacher runs on the source's device."""

    def __init__(self, source: ExampleSource, lz_weights: dict | str):
        self.source = source
        self.teacher = leela_zero.teacher(lz_weights, source.device)

    def batches(self, num_batches: int):
        for feats, labels in self.source.batches(num_batches):
            lz = labels.pop("lz_features")
            value, policy = self.teacher(lz)
            yield feats, dict(
                labels, policy=policy, value=value,
                has_ownership=torch.zeros_like(labels["has_ownership"]))
