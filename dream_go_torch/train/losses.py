"""Training losses and accuracy metrics (port of
`dream_go_tpu/train/losses.py`, `model_fn.py:48-78,160-183`,
`layers/value_head.py:66-76`):

- policy: softmax cross-entropy against the recorded search distribution,
  label smoothing 0.2, weight 0.12;
- value: Huber(winner, value), weight 1.0;
- ownership: per-point two-class CE with label smoothing 0.2, weight 1.0,
  masked by ``has_ownership``;
- metrics: policy top-1/3/5 accuracy, value sign accuracy, ownership sign
  accuracy.

``outputs`` is the towers' ``(policy_logits[B, 362], value[B],
ownership[B, 361])``, float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import TrainConfig


def _smooth(labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    return labels * (1.0 - smoothing) + smoothing / labels.shape[-1]


def policy_loss(logits, labels, smoothing: float = 0.2) -> torch.Tensor:
    """[B] softmax CE with label smoothing."""
    return -(_smooth(labels, smoothing)
             * F.log_softmax(logits, dim=-1)).sum(-1)


def huber(x, y, delta: float = 1.0) -> torch.Tensor:
    err = (x - y).abs()
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad * quad + delta * (err - quad)


def ownership_loss(logits, labels, smoothing: float = 0.2) -> torch.Tensor:
    """[B] mean per-point two-class CE: ``labels`` in {-1, 0, +1} as
    ``[(1+y)/2, (1-y)/2]`` against the logits ``[z, -z]``."""
    cat_labels = _smooth(torch.stack([(1.0 + labels) / 2.0,
                                      (1.0 - labels) / 2.0], -1), smoothing)
    logp = F.log_softmax(torch.stack([logits, -logits], -1), dim=-1)
    return (-(cat_labels * logp).sum(-1)).mean(-1)


def total_loss(outputs, labels: dict, cfg: TrainConfig):
    """``(scalar loss, metrics dict of 0-d tensors)``; ``labels`` holds
    policy[B, 362], value[B] (+-1), ownership[B, 361], has_ownership[B]."""
    logits, value, ownership = outputs
    lp = policy_loss(logits, labels["policy"], cfg.label_smoothing)
    lv = huber(labels["value"], value)
    lo = ownership_loss(ownership, labels["ownership"],
                        cfg.label_smoothing) * labels["has_ownership"]
    loss = (cfg.policy_coef * lp + cfg.value_coef * lv
            + cfg.ownership_coef * lo).mean()
    metrics = dict(loss=loss, loss_policy=lp.mean(), loss_value=lv.mean(),
                   loss_ownership=lo.mean(),
                   **accuracy_metrics(outputs, labels))
    return loss, metrics


def accuracy_metrics(outputs, labels: dict) -> dict:
    """Policy top-1/3/5, value sign, ownership sign.  The target is in the
    top k when fewer than k logits precede it in a stable descending sort
    (``jnp.argsort(-logits)``): those above it, and those equal to it at
    a lower index, so tied logits rank as in the JAX package."""
    logits, value, ownership = outputs
    target = labels["policy"].argmax(-1)
    lt = logits.gather(1, target[:, None])
    idx = torch.arange(logits.shape[-1], device=logits.device)
    ahead = ((logits > lt) | ((logits == lt) & (idx < target[:, None]))
             ).sum(-1)
    topk = lambda k: (ahead < k).float().mean()
    value_acc = (torch.sign(value) == torch.sign(labels["value"])
                 ).float().mean()
    hits, counted = ownership_counts(ownership, labels)
    own_acc = hits / torch.clamp(counted, min=1.0)
    return dict(policy_top1=topk(1), policy_top3=topk(3), policy_top5=topk(5),
                value_accuracy=value_acc, ownership_accuracy=own_acc)


def ownership_counts(ownership, labels: dict):
    """``(points whose ownership sign is right, points counted)``: the
    ownership accuracy's numerator and denominator, which a mesh sums
    over its data group."""
    own_mask = labels["has_ownership"][:, None] * (labels["ownership"] != 0)
    hits = ((torch.sign(ownership) == torch.sign(labels["ownership"]))
            * own_mask).sum()
    return hits, own_mask.sum()
