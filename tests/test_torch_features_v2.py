"""The port's V2 plane set, ``features_v1_full``, ``apply_symmetry`` and a
V2 search against the JAX package: bit-exact planes on random mid-game
boards (ladders off, greedy and exact), and equal search trees."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.go import features as JF
from dream_go_tpu.mcts import search as JS
from dream_go_torch.config import SearchConfig as TSC
from dream_go_torch.go import features as TF
from dream_go_torch.mcts import search as TS
from test_torch_search import _assert_trees_equal

#: komi per board: both signs, inside and past the clip at +-7.5
KOMI = np.asarray([7.5, -7.5, 0.5, 12.0, -30.0, 3.25, 6.5, -2.0], np.float32)
#: a black group with two eyes at a1 and c1, (x, y) points
EYES_BLACK = [(1, 0), (3, 0), (0, 1), (1, 1), (2, 1), (3, 1)]
EYES_WHITE = [(10, 10), (12, 12), (14, 10), (10, 14), (16, 16), (12, 8)]


def _scripted():
    """The two-eyed group with black, then white, to move (Benson eyes
    for the player to move and for the opponent)."""
    from dream_go_tpu.go import engine as jeng

    moves = [y * 19 + x for pair in zip(EYES_BLACK, EYES_WHITE)
             for x, y in pair]
    states = jeng.new_states(2)
    for m in moves:
        states = B._step(states, jnp.asarray([m, m], jnp.int32))
    white = B._step(states, jnp.asarray([361, 361], jnp.int32))
    return jax.tree_util.tree_map(lambda a, b: jnp.stack([a[0], b[1]]),
                                  states, white)


@functools.lru_cache(maxsize=None)
def _boards():
    """Six boards of random play (0 to 220 moves) and the two scripted
    ones, with varied komi."""
    js = B.random_states(6, [0, 30, 70, 120, 170, 220], 5, pass_prob=0.02)
    js = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                js, _scripted())
    return js.replace(komi=jnp.asarray(KOMI))


@functools.lru_cache(maxsize=None)
def _jax_v2(with_ladders, exact):
    fn = jax.jit(jax.vmap(lambda s: JF.features_v2(s, with_ladders, exact)))
    return np.asarray(fn(_boards()))


@pytest.mark.parametrize("with_ladders", [False, True])
def test_features_v2_matches_jax(with_ladders):
    """Ladders from the greedy reader, as both packages read them on the
    CPU."""
    want = _jax_v2(with_ladders, False)
    got = TF.features_v2(B.to_torch(_boards()), with_ladders).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 19, 19, 18)
    # the planes these boards are meant to reach are set somewhere
    flat = got.reshape(8, 361, 18)
    for plane in (4, 5, 8, 9, 11, 12) + ((14, 15) if with_ladders else ()):
        assert flat[..., plane].any(), plane


def test_extract_batch_v2_matches_jax():
    """``extract_batch(feature_set="v2")`` with ladders: JAX's
    ``extract_batch(states, "v2", True)`` on the CPU is the greedy
    ``features_v2`` above."""
    got = TF.extract_batch(B.to_torch(_boards()), True, feature_set="v2")
    np.testing.assert_array_equal(got.numpy(), _jax_v2(True, False))


def test_features_v1_full_is_v1_with_bounded_ladders():
    ts = B.to_torch(_boards())
    got = TF.features_v1_full(ts, True, 24, False)
    np.testing.assert_array_equal(
        got.numpy(), TF.extract_batch(ts, True, False, False).numpy())
    np.testing.assert_array_equal(TF.features_v1_full(ts).numpy(),
                                  TF.features_v1(ts).numpy())


@pytest.mark.parametrize("sym", range(8))
def test_apply_symmetry_matches_jax(sym):
    planes = np.random.default_rng(sym).random((3, 19, 19, 18),
                                               dtype=np.float32)
    want = np.asarray(JF.apply_symmetry(jnp.asarray(planes), jnp.int32(sym)))
    got = TF.apply_symmetry(torch.from_numpy(planes), sym).numpy()
    np.testing.assert_array_equal(got, want)
    # one symmetry per example: each example as its own index would give
    per = torch.tensor([sym, (sym + 3) % 8, 7 - sym])
    got = TF.apply_symmetry(torch.from_numpy(planes), per).numpy()
    for i, s in enumerate(per.tolist()):
        np.testing.assert_array_equal(got[i], np.asarray(JF.apply_symmetry(
            jnp.asarray(planes[i]), jnp.int32(s))))


def test_v2_search_matches_jax():
    """B = 4, 8 rollouts, the unfused path (the only one V2 takes), the
    deterministic predictor on 18 planes: every tree field equal."""
    js = B.random_states(4, [10, 40, 80, 130], 3)
    tj = JS.search(js, B.det_predictor_jax(), jax.random.PRNGKey(7),
                   JSC(dirichlet_noise=0.0, feature_set="v2", fused=False), 8)
    cfg = TSC(dirichlet_noise=0.0, feature_set="v2").resolve_auto("cpu")
    tt = TS.search(B.to_torch(js), B.det_predictor_torch(),
                   torch.Generator().manual_seed(0), cfg, 8)
    _assert_trees_equal(tt, tj)


def test_resolve_auto_keeps_v2_unfused():
    assert TSC(feature_set="v2").resolve_auto("cuda").fused is False
    assert TSC(feature_set="v2", fused=False).resolve_auto("cuda").fused \
        is False
    assert TSC().resolve_auto("cuda").fused is True
    with pytest.raises(ValueError):
        TSC(feature_set="v2", fused=True).resolve_auto("cuda")
    with pytest.raises(ValueError):
        TSC(feature_set="v2", fused=True).resolve_auto("cpu")


def test_scorable_territory_matches_jax():
    """`benson.scorable_territory` on the random and scripted boards (the
    scripted ones hold a two-eyed group whose stones and eyes are
    decided)."""
    from dream_go_tpu.go import benson as JB
    from dream_go_torch.go import benson as TB

    js = _boards()
    want = np.asarray(jax.jit(jax.vmap(JB.scorable_territory))(js))
    ts = B.to_torch(js)
    got = TB.scorable_territory(ts)
    assert got.dtype == torch.bool and got.shape == (8, 361)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[6:].sum(-1).min() >= len(EYES_BLACK) + 2
    np.testing.assert_array_equal(
        TB.scorable_territory(ts, TB.life(ts)).numpy(), want)
