"""Search trees that reach every path of the select walk.

The card tests (`tests/test_torch_cuda.py`), `chip_smoke.py` and the CPU
tests hold the select-walk kernel (`ops/select_walk.py`) to its plain
version, and the plain version to the JAX package's, on these trees:

- :func:`grown_trees`: trees the port's own search grows from random
  positions with :func:`case_predictor` (a deterministic predictor whose
  rows are flat, peaked or hashed: equal priors and ties, deep lines,
  varied trees); ``slots=2`` fills the sparse slots, so full-slot nodes
  force slot use;
- :func:`line_trees`: a single-point policy grows a line deeper than
  ``MAX_BACKUP_DEPTH``, so the walk stops at the depth bound on an
  existing edge (``k_exit >= 0``);
- :func:`perturbed`: the same trees with every statistic redrawn (visit
  counts across the schedules' knots and beyond, values that clamp the
  first-play urgency to 0, unvisited occupied slots, priors from eight
  levels so that scores tie, random candidate bits), and roots with no
  candidate (root action ``A - 1``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SearchConfig
from ..go import engine
from .predictor import Predictor, fake_predictor
from .search import A, Tree, search


def case_predictor() -> Predictor:
    """A deterministic predictor: a hash ``h`` of the feature bits makes
    the row flat (``h % 3 == 0``: every prior equal), peaked (``1``: the
    action of rank r gets 2^-r) or hashed (``2``), and the value."""

    def predict(feats):
        bits = (feats > 0.5).to(torch.int64)
        w = torch.arange(bits[0].numel(), device=feats.device) % 7 + 1
        h = (bits.reshape(bits.shape[0], -1) * w).sum(1)
        a = torch.arange(A, device=feats.device)
        k = (h[:, None] * 31 + a[None, :] * 17) % 251 + 1
        rank = (h[:, None] * 31 + a[None, :] * 17) % A
        peaked = torch.exp2(-rank.float()) * (rank < 24)
        style = (h % 3)[:, None]
        policy = torch.where(style == 0, torch.ones_like(peaked),
                             torch.where(style == 1, peaked,
                                         k.float() / 4096.0))
        value = ((h % 200) + 28).float() / 256.0
        return value, policy

    return Predictor(predict)


def random_positions(device, batch: int, seed: int) -> engine.GoState:
    """Positions of random legal play, board i stopped after ``(7 i) %
    41`` moves."""
    gen = torch.Generator(device=device).manual_seed(seed)
    states = engine.new_states(batch, device=device)
    target = (torch.arange(batch, device=device) * 7) % 41
    for i in range(int(target.max()) if batch else 0):
        legal = engine.legal_mask(states)[:, :361]
        w = torch.where(legal.any(1, keepdim=True), legal.float(), 1.0)
        act = torch.multinomial(w, 1, generator=gen)[:, 0]
        act = torch.where(legal.any(1), act, 361).to(torch.int32)
        states = states.select(i >= target, engine.step(states, act))
    return states


def grown_trees(device, batch: int, sims: int, slots: int = 32,
                seed: int = 0, capacity: int | None = None):
    """``(trees, cfg)``: ``sims`` simulations of the port's search (fused
    leaf step, no noise) from :func:`random_positions`."""
    cfg = SearchConfig(dirichlet_noise=0.0, fused=True, children_slots=slots)
    trees = search(random_positions(device, batch, seed), case_predictor(),
                   torch.Generator(device=device).manual_seed(seed), cfg,
                   sims, capacity=capacity)
    return trees, cfg


def line_trees(device, batch: int = 2, sims: int = 140,
               capacity: int = 150, slots: int = 32):
    """``(trees, cfg)``: a single-point policy at (15, 3) and a constant
    value grow one line from empty boards, past ``MAX_BACKUP_DEPTH`` at
    the default sizes."""
    cfg = SearchConfig(dirichlet_noise=0.0, fused=True, children_slots=slots)
    trees = search(engine.new_states(batch, device=device),
                   fake_predictor(72, value=0.6),
                   torch.Generator(device=device).manual_seed(0), cfg, sims,
                   capacity=capacity)
    return trees, cfg


def perturbed(t: Tree, seed: int, no_candidates: int = 1) -> Tree:
    """``t``'s structure (children, slot actions) with every statistic
    redrawn from ``seed``; the first ``no_candidates`` roots lose every
    candidate bit."""
    gen = torch.Generator(device=t.size.device).manual_seed(seed)
    dev = t.size.device

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev)

    b, c = t.node_n.shape
    # visit counts below, between and beyond the schedules' knots
    node_n = torch.where(uniform((b, c)) < 0.5, ints((b, c), 50),
                         ints((b, c), 6000))
    levels = ints(t.prior.shape, 8).float() / 8.0
    cand = ints(t.cand.shape, 1 << 16) | (ints(t.cand.shape, 1 << 16) << 16)
    cand[:no_candidates, 0] = 0
    slot_n = torch.where(uniform(t.slot_n.shape) < 0.2, 0,
                         ints(t.slot_n.shape, 40))
    root_n = torch.where((t.root_child >= 0)
                         | (uniform(t.root_edge_n.shape) < 0.1),
                         ints(t.root_edge_n.shape, 400), 0)
    # odd boards favour the existing edges (no prior off them, low net
    # values, high edge values), so their walks go deep; even boards
    # leave the tree early
    odd = (torch.arange(b, device=dev) % 2 == 1)
    edge = torch.zeros(b, c, A + 1, dtype=torch.bool, device=dev)
    edge.scatter_(2, torch.where(t.slot_action >= 0, t.slot_action,
                                 A).long(), True)
    edge[:, 0, :A] |= t.root_child >= 0
    levels = torch.where(odd[:, None, None] & ~edge[..., :A], 0.0, levels)
    value0 = uniform((b, c)) * torch.where(odd, 0.2, 1.0)[:, None]
    lo = torch.where(odd, 0.6, 0.0)
    return dataclasses.replace(
        t, node_n=node_n, value0=value0,
        prior=levels.to(torch.bfloat16), cand=cand, slot_n=slot_n,
        slot_w=(lo[:, None, None] + (1 - lo[:, None, None])
                * uniform(t.slot_w.shape)) * slot_n,
        root_edge_n=root_n,
        root_edge_w=(lo[:, None] + (1 - lo[:, None])
                     * uniform(t.root_edge_w.shape)) * root_n)

