"""Port features, search options, Benson and scoring on random mid-game
boards, against the JAX package (exact)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.go import benson as jb
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.go import features as jf
from dream_go_tpu.go import options as jo
from dream_go_tpu.go import score as jsc
from dream_go_tpu.selfplay import policy as jpol
from dream_go_torch.go import benson as tb
from dream_go_torch.go import features as tf
from dream_go_torch.go import options as to
from dream_go_torch.go import score as tsc
from dream_go_torch.selfplay import policy as tpol


def _living_group_moves():
    """Black builds a two-eye corner group (eyes at (0,0) and (2,0))
    while white plays far away, then white wraps part of it."""
    p = lambda x, y: 19 * y + x
    black = [p(1, 0), p(0, 1), p(1, 1), p(2, 1), p(3, 1), p(3, 0)]
    white = [p(10, 10), p(10, 11), p(4, 0), p(4, 1), p(3, 2), p(2, 2)]
    return [m for pair in zip(black, white) for m in pair]


@functools.lru_cache(maxsize=None)
def _boards():
    """JAX states: random mid-game boards plus a living group."""
    js = B.random_states(5, [0, 35, 110, 190, 270], 11, pass_prob=0.02)
    live = jeng.new_states(1)
    step = jax.jit(jax.vmap(jeng.step))
    for m in _living_group_moves():
        live = step(live, jnp.asarray([m], jnp.int32))
    return jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), js, live)


def _pair():
    js = _boards()
    return js, B.to_torch(js)


def test_features_v1_matches():
    js, ts = _pair()
    want = np.asarray(jax.vmap(jf.features_v1)(js))
    got = tf.features_v1(ts).numpy()
    assert np.argwhere(got != want).size == 0
    np.testing.assert_array_equal(tf.extract_batch(ts).numpy(), want)


@pytest.mark.parametrize("color", [1, 2])
def test_liberties_if_matches_where_pseudo_legal(color):
    js, ts = _pair()
    valid = np.asarray(jax.vmap(
        lambda s: jeng.pseudo_legal_mask(s, color))(js))
    want = np.asarray(jax.vmap(lambda s: jf.liberties_if(s, color))(js))
    got = tf.liberties_if(ts, color).numpy()
    np.testing.assert_array_equal(np.where(valid, got, 0),
                                  np.where(valid, want, 0))


@pytest.mark.parametrize("name", ["standard_mask", "scoring_mask",
                                  "eye_heuristic"])
def test_option_masks_match(name):
    js, ts = _pair()
    want = np.asarray(jax.vmap(getattr(jo, name))(js))
    np.testing.assert_array_equal(getattr(to, name)(ts).numpy(), want)


@pytest.mark.parametrize("color", [1, 2])
def test_benson_matches(color):
    js, ts = _pair()
    ja, je = jax.vmap(lambda s, c: jb.benson(s, c, color))(
        js.stones, js.chain_id)
    ta, te = tb.benson(ts.stones, ts.chain_id, color)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    if color == 1:  # the constructed corner group is pass-alive
        assert ta.numpy()[-1].sum() == 6


def test_label_components_matches():
    js, ts = _pair()
    for mask in (ts.stones.numpy() != 1, ts.stones.numpy() == 0):
        want = np.asarray(jax.vmap(jb.label_components)(jnp.asarray(mask)))
        got = tb.label_components(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)


def test_scoring_matches():
    js, ts = _pair()
    np.testing.assert_array_equal(tb.is_scorable(ts).numpy(),
                                  np.asarray(jax.vmap(jb.is_scorable)(js)))
    np.testing.assert_array_equal(tsc.final_score(ts).numpy(),
                                  np.asarray(jax.vmap(jsc.final_score)(js)))
    for got, want in zip(tsc.territory(ts.stones),
                         jax.vmap(jsc.territory)(js.stones)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpol._final_territory(ts).numpy(),
                                  np.asarray(jpol._final_territory(js)))
    for got, want in zip(
            tb.stone_status(ts.stones, ts.chain_id, ts.stones, ts.chain_id),
            jax.vmap(jb.stone_status)(js.stones, js.chain_id, js.stones,
                                      js.chain_id)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_komi_matches():
    np.testing.assert_array_equal(tpol.random_komi(64, 5),
                                  jpol.random_komi(64, 5))
