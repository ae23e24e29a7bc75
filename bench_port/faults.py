"""Faults planted in the timed path, to show that the checks catch them.

Each fault is a list of ``(module, attribute, replacement)`` patches of
the program, applied for one run:

- ``unchanged``: a step returns its state unchanged (the leaf kernel
  hands back the parent's board; the trainer's step leaves the weights
  as they were);
- ``half``: half of the batch left out, the rest standing in for it (the
  tower evaluates the first half of a batch and gives the second half the
  first half's mean; the trainer steps on the first half);
- ``answer``: one answer altered where it is produced (the tower's
  policy of one board a batch, a different board each call, reversed);
- ``value``: the tower's win rates handed to the search from the other
  side's perspective (one minus each);
- ``labels``: the trainer's batches augmented with a symmetry on the
  planes and none on the policy and ownership labels.
"""

from __future__ import annotations

import torch

SELFPLAY = ("unchanged", "half", "answer", "value")
TRAIN = ("unchanged", "half", "labels")


def patches(kind: str, fault: str) -> list:
    from dream_go_torch.mcts import predictor as P
    from dream_go_torch.mcts import search as S
    from dream_go_torch.train import pipeline as PL
    from dream_go_torch.train import train_loop as TL

    if kind == "selfplay":
        if fault == "unchanged":
            real = S.leaf_step

            def leaf_step(stones, cid, cxp, hist, meta, hashw, action, komi):
                _, feats, cand = real(stones, cid, cxp, hist, meta, hashw,
                                      action, komi)
                return (stones, cid, cxp, hist, meta, hashw), feats, cand

            return [(S, "leaf_step", leaf_step)]
        real_planes = P.NetPredictor.planes
        if fault == "half":
            def planes(self, x):
                h = max(1, x.shape[0] // 2)
                value, policy = real_planes(self, x[:h])
                rest = x.shape[0] - h
                return (torch.cat([value, value.mean(0, True).expand(rest)]),
                        torch.cat([policy, policy.mean(0, True)
                                   .expand(rest, -1)]))

            return [(P.NetPredictor, "planes", planes)]
        if fault == "answer":
            calls = [0]

            def planes(self, x):
                value, policy = real_planes(self, x)
                i = calls[0] % x.shape[0]
                calls[0] += 1
                policy = policy.clone()
                policy[i] = policy[i].flip(0)
                return value, policy

            return [(P.NetPredictor, "planes", planes)]
        if fault == "value":
            def planes(self, x):
                value, policy = real_planes(self, x)
                return 1.0 - value, policy

            return [(P.NetPredictor, "planes", planes)]
    if kind == "train":
        real_step = TL.train_step
        if fault == "unchanged":
            def train_step(model, optimizer, cfg, feats, labels, lr,
                           mesh=None):
                before = [p.detach().clone() for p in model.parameters()]
                out = real_step(model, optimizer, cfg, feats, labels, lr,
                                mesh)
                with torch.no_grad():
                    for p, q in zip(model.parameters(), before):
                        p.copy_(q)
                return out

            return [(TL, "train_step", train_step)]
        if fault == "half":
            def train_step(model, optimizer, cfg, feats, labels, lr,
                           mesh=None):
                h = feats.shape[0] // 2
                return real_step(model, optimizer, cfg, feats[:h],
                                 {k: v[:h] for k, v in labels.items()}, lr,
                                 mesh)

            return [(TL, "train_step", train_step)]
        if fault == "labels":
            real_augment = PL._augment

            def augment(feats, labels, gen, feature_set, sym=None, u=None):
                return real_augment(feats, labels, gen, feature_set, sym,
                                    u)[0], labels

            return [(PL, "_augment", augment)]
    raise ValueError(f"no fault {fault!r} for {kind!r}")
