"""The select walk's plain version (`ops/select_walk.py`, the CPU path and
the card kernel's reference) against the JAX package's ``_select_flat``,
on the trees of `mcts/walk_cases.py`: grown by the port's search, with
their statistics redrawn, two slots, and a line past the depth bound.
The kernel itself is held to the plain version on the card
(`tests/test_torch_cuda.py`)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.mcts import search as JS
from dream_go_torch.mcts import search as TS
from dream_go_torch.mcts import walk_cases as WC
from dream_go_torch.ops import select_walk as SW

CASES = ("grown", "grown_k2", "redrawn", "redrawn_k2", "line", "line_redrawn")
OUTPUTS = ("node", "action", "k_exit", "path_n", "path_k", "root_a")


@functools.lru_cache(maxsize=None)
def _case(name):
    if name.startswith("line"):
        t, cfg = WC.line_trees("cpu")
    else:
        slots = 2 if name.endswith("k2") else 32
        t, cfg = WC.grown_trees("cpu", 8, 40, slots=slots, seed=slots)
    if "redrawn" in name:
        t = WC.perturbed(t, 1, no_candidates=2)
    return t, cfg


def _jax_tree(t):
    """The flat JAX tree of a port tree (board rows left out: the walk
    does not read them)."""
    kw = {f.name: jnp.asarray(getattr(t, f.name).numpy().reshape(
        (-1,) + tuple(getattr(t, f.name).shape[2:])))
        for f in dataclasses.fields(t)
        if f.name not in TS._GAME_FIELDS + ("states", "prior", "cand")}
    for name in TS._GAME_FIELDS:
        kw[name] = jnp.asarray(getattr(t, name).numpy())
    kw["prior"] = jnp.asarray(t.prior.float().numpy().reshape(-1, SW.A)) \
        .astype(jnp.bfloat16)
    kw["cand"] = jnp.asarray(t.cand.numpy().view(np.uint32)
                             .reshape(-1, SW.NCW))
    return JS.Tree(states=None, **kw)


def _walks(name):
    t, cfg = _case(name)
    b, c = t.node_n.shape
    got = TS._select_flat(t, cfg, b, c)
    want = JS._select_flat(
        _jax_tree(t), JSC(children_slots=t.slot_action.shape[-1]), b, c)
    return got, want


@pytest.mark.parametrize("name", CASES)
def test_select_walk_plain_matches_jax(name):
    got, want = _walks(name)
    for out, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == torch.int32, out
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), out)


def test_walk_cases_reach_each_path():
    """The line walks stop at the depth bound on an existing edge; the
    redrawn roots without a candidate take A - 1; two slots fill, so some
    walk passes a full-slot node; flat priors tie at some root."""
    (_, _, k_exit, path_n, _, _), _ = _walks("line")
    assert bool((k_exit >= 0).all()) and bool((path_n >= 0).all())
    assert path_n.shape[1] == SW.MAX_BACKUP_DEPTH
    root_a = _walks("redrawn")[0][5]
    assert root_a[:2].tolist() == [SW.A - 1] * 2
    t, _ = _case("grown_k2")
    path_n = _walks("grown_k2")[0][3]
    full = (t.slot_action >= 0).all(-1)
    rows = torch.arange(t.node_n.shape[0])[:, None]
    assert bool(full[rows, path_n.clamp(min=0)][:, 1:].any())
    t, _ = _case("grown")
    cand0 = SW.unpack_cand(t.cand[:, 0])
    p0 = t.prior[:, 0].float()
    lo = torch.where(cand0, p0, 2.0).min(1).values
    hi = torch.where(cand0, p0, -1.0).max(1).values
    assert bool((lo == hi).any())


def test_select_walk_takes_plain_on_cpu_and_refuses_other_devices():
    t, cfg = _case("grown")
    b, c = t.node_n.shape
    before = SW.launches
    for g, w in zip(SW.select_walk(t, cfg.uct_exp, cfg.fpu_reduce, b, c),
                    SW.select_walk_plain(t, cfg.uct_exp, cfg.fpu_reduce, b,
                                         c)):
        assert torch.equal(g, w)
    assert SW.launches == before
    meta = dataclasses.replace(t, size=t.size.to("meta"))
    with pytest.raises(ValueError):
        SW.select_walk(meta, cfg.uct_exp, cfg.fpu_reduce, b, c)
    knots = SW._knots(cfg.uct_exp, cfg.fpu_reduce, "cpu")
    assert knots.tolist() == [44.0, 2536.0, 1.8700000047683716,
                              1.4800000190734863, 44.0, 3817.0,
                              0.6700000166893005, 0.46000000834465027]
