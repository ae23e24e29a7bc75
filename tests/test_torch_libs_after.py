"""The plain version of the port's liberties-after feature kernel
(`ops.libs_after`) against the Pallas kernel of the JAX package in
interpret mode, on random boards and on the scripted boards that reach
each counting path of the card kernel (`boards.FEATURE_CASES`), and the
kernel feature path with ladder planes
(`features.extract_batch(use_kernel=True, with_ladders=True)`) against the
JAX package's, bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.go import features as jf
from dream_go_tpu.ops import libs_after as jla
from dream_go_torch.go import boards, engine
from dream_go_torch.go import features as tf
from dream_go_torch.go.topology import NBR, NN
from dream_go_torch.ops import layout
from dream_go_torch.ops import libs_after as tla

ROWS = ("libs_if_black", "libs_if_white", "point_libs", "pseudo_black",
        "pseudo_white")
#: per scripted case, the path black and white take at its point: 0 no
#: own chain (a direct count), 1 one own chain and no capture (a direct
#: count), 2 the set union (two or more own chains, or one and a capture)
CASE_PATHS = {
    "atari through two stones": (0, 1),
    "own chain from two sides": (1, 0),
    "two own chains": (2, 0),
    "three own chains": (2, 0),
    "own chain and a capture": (2, 1),
    "stone captured with its chain": (1, 2),
    "single stone": (0, 1),
    "edges and corners": (2, 0),
    "long chain": (2, 0),
    "most chains": (0, 2),
}


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


def test_feature_cases_match_pallas():
    """The scripted boards and their colour swaps, as one batch: all five
    rows at every point."""
    ts = boards.feature_cases(torch.device("cpu"))
    js = jeng.GoState(**{k: jnp.asarray(v)
                         for k, v in B.to_numpy(ts).items()})
    want = jla.board_features_raw(js, interpret=True)
    rows = layout.pack_states(ts)
    got = tla.features_raw_plain(rows[0], rows[1])
    for i, k in enumerate(ROWS):
        np.testing.assert_array_equal(
            got[:, i].numpy(), np.asarray(want[k]).astype(np.int32),
            err_msg=k)


def _path(stones, cid, chain_libs, q, colour) -> int:
    own, cap = set(), set()
    for n in NBR[q]:
        if n >= NN:
            continue
        if stones[n] == colour:
            own.add(cid[n])
        elif stones[n] == 3 - colour and chain_libs[cid[n]] == 1:
            cap.add(cid[n])
    return 0 if not own else (1 if len(own) == 1 and not cap else 2)


@pytest.mark.parametrize("case", range(len(boards.FEATURE_CASES)))
def test_feature_case_reaches_its_path(case):
    """Each scripted board is a legal position (every chain has a
    liberty), and its point takes the path it is named for, for each
    colour, with the colours swapped too."""
    name, _, _, q = boards.FEATURE_CASES[case]
    ts = boards.feature_cases(torch.device("cpu"))
    point_libs, chain_libs = engine.chain_liberties(ts.stones, ts.chain_id)
    n = len(boards.FEATURE_CASES)
    for i, swap in ((case, False), (case + n, True)):
        stones, cid = ts.stones[i].tolist(), ts.chain_id[i].tolist()
        assert int(point_libs[i][ts.stones[i] > 0].min()) >= 1, name
        got = tuple(_path(stones, cid, chain_libs[i].tolist(), q, c)
                    for c in ((2, 1) if swap else (1, 2)))
        assert got == CASE_PATHS[name], (name, swap)
    if name == "most chains":
        assert len(set(cid[q] for q in range(361) if stones[q])) > 250
