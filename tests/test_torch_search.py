"""Port MCTS against `dream_go_tpu.mcts.search`: the same deterministic
predictor in both packages, Dirichlet noise off, equal tree statistics."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.mcts import choose as JC
from dream_go_tpu.mcts import search as JS
from dream_go_torch.config import SearchConfig as TSC
from dream_go_torch.mcts import choose as TC
from dream_go_torch.mcts import search as TS

SIMS = 24
#: every integer statistic and every float statistic of the trees
FIELDS = ("root_edge_n", "root_child", "slot_action", "slot_child", "slot_n",
          "node_n", "parent", "parent_action", "parent_slot", "node_to_move",
          "size", "root_edge_w", "slot_w", "node_w", "node_m2", "value0")


@functools.lru_cache(maxsize=None)
def _jax_case():
    js = B.random_states(4, [12, 12, 40, 90], 3)
    trees = JS.search(js, B.det_predictor_jax(), jax.random.PRNGKey(7),
                      JSC(dirichlet_noise=0.0), SIMS)
    return js, trees


@functools.lru_cache(maxsize=None)
def _torch_trees(fused):
    js, _ = _jax_case()
    return TS.search(B.to_torch(js), B.det_predictor_torch(),
                     torch.Generator().manual_seed(0),
                     TSC(dirichlet_noise=0.0, fused=fused), SIMS)


def _assert_trees_equal(tt, tj):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), f)
    np.testing.assert_array_equal(tt.prior.float().numpy(),
                                  np.asarray(tj.prior.astype(jnp.float32)))
    np.testing.assert_array_equal(tt.cand.numpy().view(np.uint32),
                                  np.asarray(tj.cand))


@pytest.mark.parametrize("fused", [True, False])
def test_search_matches_jax(fused):
    _, tj = _jax_case()
    tt = _torch_trees(fused)
    _assert_trees_equal(tt, tj)
    rows = TS.unpack_rows(TS._map(tt.states, lambda x: x[:, 0])) if fused \
        else TS._map(tt.states, lambda x: x[:, 0])
    np.testing.assert_array_equal(rows.stones.numpy(),
                                  np.asarray(tj.states.stones[:, 0]))


def test_step_kernel_search_matches_jax():
    """Unfused leaves stepped through env_step (one-hot weights) against
    the JAX search's engine step (its step-kernel path needs the TPU's
    generator, which interpret mode on the CPU lacks; the JAX package's
    own tests show the two steps agree): equal tree statistics, and equal
    node states, chain_xor at stones only."""
    js, tj = _jax_case()
    tt = TS.search(B.to_torch(js), B.det_predictor_torch(),
                   torch.Generator().manual_seed(0),
                   TSC(dirichlet_noise=0.0, fused=False, step_kernel=True),
                   SIMS)
    _assert_trees_equal(tt, tj)
    got = B.to_numpy(tt.states)
    stones = np.asarray(tj.states.stones) != 0
    for f in B.FIELDS:
        want = np.asarray(getattr(tj.states, f))
        if f == "chain_xor":
            got[f], want = got[f][stones], want[stones]
        np.testing.assert_array_equal(got[f], want, f)


def test_choose_weights_match():
    rng = np.random.default_rng(0)
    items = rng.integers(0, 50, (5, 362)).astype(np.float32)
    items[1] = 0.0
    items[2, :3] = np.inf
    for cutoff, temp in ((0.5, 1.0), (0.5, 0.7), (0.0, 2.0)):
        np.testing.assert_allclose(
            TC.choose_weights(torch.from_numpy(items), cutoff, temp).numpy(),
            np.asarray(JC.choose_weights(jnp.asarray(items), cutoff, temp)),
            rtol=1e-6, atol=0)
    picks = TC.choose(torch.Generator().manual_seed(1),
                      torch.from_numpy(items), 0.5, 1.0).numpy()
    w = TC.choose_weights(torch.from_numpy(items), 0.5, 1.0).numpy()
    assert picks[1] == 361
    for b in (0, 2, 3, 4):
        assert w[b, picks[b]] > 0


@functools.lru_cache(maxsize=None)
def _jax_case_ladders():
    """Planes 30/31 on, the exact reader, the feature kernel at the roots
    (and the JAX leaves): mid-game boards where ladder starts exist."""
    js = B.random_states(4, [30, 60, 110, 150], 3)
    cfg = JSC(dirichlet_noise=0.0, ladder_features=True, ladders_exact=True,
              feature_kernel=True)
    return js, JS.search(js, B.det_predictor_jax(), jax.random.PRNGKey(7),
                         cfg, 16)


@pytest.mark.parametrize("fused", [True, False])
def test_search_with_ladder_planes_matches_jax(fused):
    js, tj = _jax_case_ladders()
    ts = B.to_torch(js)
    from dream_go_torch.go import ladder as TL

    assert int(TL.ladder_planes(ts)[0].sum()) > 0
    tt = TS.search(ts, B.det_predictor_torch(),
                   torch.Generator().manual_seed(0),
                   TSC(dirichlet_noise=0.0, fused=fused, ladder_features=True,
                       ladders_exact=True, feature_kernel=True), 16)
    _assert_trees_equal(tt, tj)


def test_line_tree_past_backup_bound_matches_jax():
    """The line tree of `tests/test_mcts.py` ``test_line_tree_deeper_than_
    backup_bound``: a one-point policy at (15, 3), 140 simulations,
    capacity 150, two empty boards.  The line grows past
    MAX_BACKUP_DEPTH (128), so the walk caps and re-expands its deepest
    edge; the trees are equal, every statistic."""
    from dream_go_tpu.go import engine as jeng
    from dream_go_tpu.mcts import predictor as JP
    from dream_go_torch.mcts import predictor as TP

    js = jeng.new_states(2)
    tj = JS.search(js, JP.fake_predictor(72, value=0.6),
                   jax.random.PRNGKey(0), JSC(dirichlet_noise=0.0), 140,
                   capacity=150)
    tt = TS.search(B.to_torch(js), TP.fake_predictor(72, value=0.6),
                   torch.Generator().manual_seed(0),
                   TSC(dirichlet_noise=0.0), 140, capacity=150)
    assert np.all(np.asarray(tj.size) == 141)
    assert int(np.asarray(tj.node_n[:, 0]).max()) > TS.MAX_BACKUP_DEPTH
    _assert_trees_equal(tt, tj)


def test_two_children_slots_match_jax():
    """``children_slots=2``: a non-root node keeps two sparse slots, which
    the 24 simulations fill (and then force, as `search.py:380` does); the
    trees are equal, every statistic."""
    js, _ = _jax_case()
    tj = JS.search(js, B.det_predictor_jax(), jax.random.PRNGKey(7),
                   JSC(dirichlet_noise=0.0, children_slots=2), SIMS)
    tt = TS.search(B.to_torch(js), B.det_predictor_torch(),
                   torch.Generator().manual_seed(0),
                   TSC(dirichlet_noise=0.0, children_slots=2), SIMS)
    assert np.asarray(tj.slot_action).shape[-1] == 2
    # some non-root node has both of its slots in use
    assert ((np.asarray(tj.slot_child)[:, 1:] >= 0).sum(-1) == 2).any()
    _assert_trees_equal(tt, tj)


@pytest.mark.parametrize("fused", [True, False])
def test_dump_matches_jax(fused):
    """`mcts.dump`'s root summary and SGF export of each game of equal
    trees are the JAX package's strings."""
    from dream_go_tpu.mcts import dump as JD
    from dream_go_torch.mcts import dump as TD

    _, tj = _jax_case()
    tt = _torch_trees(fused)
    for b in range(4):
        one = jax.tree_util.tree_map(lambda x: x[b], tj)
        pretty = TD.to_pretty(tt, game=b)
        assert pretty == JD.to_pretty(one)
        assert pretty.startswith(f"Nodes: {int(tt.node_n[b, 0])}, ")
        assert TD.to_pretty(tt, 3, game=b) == JD.to_pretty(one, 3)
        assert TD.to_sgf(tt, komi=6.5, game=b) == JD.to_sgf(one, komi=6.5)
        assert TD.to_sgf(tt, meta=False, min_visits=2, game=b) == \
            JD.to_sgf(one, meta=False, min_visits=2)
