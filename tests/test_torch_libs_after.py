"""The plain version of the port's liberties-after feature kernel
(`ops.libs_after`) against the Pallas kernel of the JAX package in
interpret mode, and the kernel feature path with ladder planes
(`features.extract_batch(use_kernel=True, with_ladders=True)`) against the
JAX package's, bit for bit."""

import functools

import jax
import numpy as np
import pytest

import _torch_bridge as B
from dream_go_tpu.go import features as jf
from dream_go_tpu.ops import libs_after as jla
from dream_go_torch.go import features as tf
from dream_go_torch.ops import layout
from dream_go_torch.ops import libs_after as tla


@functools.lru_cache(maxsize=None)
def _boards():
    js = B.random_states(4, [0, 30, 120, 220], 9, pass_prob=0.02)
    return js, B.to_torch(js)


def test_board_features_raw_matches_pallas():
    js, ts = _boards()
    want = jla.board_features_raw(js, interpret=True)
    got = tla.board_features_raw(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype.is_floating_point is False
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_liberties_after_both_matches_pallas():
    js, ts = _boards()
    want = jla.liberties_after_both(js, interpret=True)
    got = tla.liberties_after_both(ts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_features_raw_rows_match_the_wrappers():
    _, ts = _boards()
    rows = layout.pack_states(ts)
    out = tla.features_raw(rows[0], rows[1])
    raw = tla.board_features_raw(ts)
    assert out.shape == (4, 5, 361)
    np.testing.assert_array_equal(out[:, 2].numpy(),
                                  raw["point_libs"].numpy())


@pytest.mark.parametrize("with_ladders", [False, True])
def test_kernel_feature_path_matches_jax(with_ladders):
    js, ts = _boards()
    want = np.asarray(jax.jit(functools.partial(
        jf.extract_batch, feature_set="v1", with_ladders=with_ladders,
        use_kernel=True, ladders_exact=False))(js))
    got = tf.extract_batch(ts, with_ladders, True, False).numpy()
    np.testing.assert_array_equal(got, want)
    # the kernel path and the plain path give the same planes
    np.testing.assert_array_equal(
        got, tf.extract_batch(ts, with_ladders, False, False).numpy())
    if with_ladders:
        assert got[..., 30].sum() > 0
