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
