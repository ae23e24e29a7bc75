"""Port leaf_step against the Pallas leaf_step (interpret mode).  The CUDA
kernel's own tests are in test_torch_cuda.py, which imports no JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.ops import env_step as jes
from dream_go_tpu.ops.leaf_step import leaf_step as pallas_leaf_step
from dream_go_torch.go.boards import (KO_ACTION, KO_MOVES, KO_RECAPTURE,
                                      LEAF_CASES, LEAF_KO, leaf_cases)
from dream_go_torch.ops import layout as tl
from dream_go_torch.ops import leaf_step as L


@functools.lru_cache(maxsize=None)
def _ko_state():
    s = jeng.new_states(1)
    step = jax.jit(jax.vmap(jeng.step))
    for m in KO_MOVES:
        s = step(s, jnp.asarray([m], jnp.int32))
    return s


@functools.lru_cache(maxsize=None)
def _case():
    """(JAX states, actions), batch 8: mid-game boards stopped between 15
    and 250 moves, a pass, a pass that ends the game, a finished game, and
    a capture that leaves a super-ko in the ring."""
    js = B.random_states(7, [15, 60, 120, 180, 250, 40, 90], 1)
    acts = B.legal_actions(js, 101)
    acts[4] = 361                                      # a pass
    acts[5] = 361                                      # second pass: done
    js = js.replace(pass_count=js.pass_count.at[5].set(1))
    js = js.replace(done=js.done.at[6].set(True))      # finished: frozen
    js = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), js, _ko_state())
    return js, np.concatenate([acts, [KO_ACTION]]).astype(np.int32)


def test_leaf_step_plain_matches_pallas():
    js, acts = _case()
    ts = B.to_torch(js)
    want_state, want_feats, want_cand = pallas_leaf_step(
        *jes.pack_states(js), jnp.asarray(acts), js.komi, interpret=True)
    before = L.launches
    got_state, got_feats, got_cand = L.leaf_step(
        *tl.pack_states(ts), torch.from_numpy(acts), ts.komi)
    assert L.launches == before  # CPU tensors take the plain version
    for got, want in zip(got_state, want_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mismatch = np.argwhere(got_feats.numpy() != np.asarray(want_feats))
    assert mismatch.size == 0, mismatch[:20]
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    # the cases are what they claim to be
    meta = got_state[4].numpy()[:, 0]
    assert meta[5, 4] == 1 and meta[6, 4] == 1 and meta[4, 3] == 1
    # black's capture at KO_ACTION makes white's recapture a super-ko
    assert got_feats.numpy()[-1, 29, KO_RECAPTURE] == 1.0
    assert not got_cand.numpy()[-1, KO_RECAPTURE]


@functools.lru_cache(maxsize=None)
def _scripted(i):
    """JAX state (batch 1) of ``LEAF_CASES[i]``, replayed with the JAX
    engine."""
    s = jeng.new_states(1)
    step = jax.jit(jax.vmap(jeng.step))
    for m in LEAF_CASES[i][1]:
        s = step(s, jnp.asarray([m], jnp.int32))
    return s


@pytest.mark.parametrize("case", [c[0] for c in LEAF_CASES])
def test_leaf_step_plain_matches_pallas_on_scripted_boards(case):
    """The boards that reach the CUDA kernel's counting paths (three chains
    merged, two captured at once, set unions, a super-ko in a wrapped
    ring, a chain captured through two of its stones, by the move and by a
    super-ko candidate): the port's plain version against the Pallas
    kernel, and the port's engine replays the moves to the JAX engine's
    state."""
    i = [c[0] for c in LEAF_CASES].index(case)
    js = _scripted(i)
    act = np.asarray([LEAF_CASES[i][2]], np.int32)
    ts = B.to_torch(js)
    port, port_act = leaf_cases("cpu")
    for a, b in zip(tl.pack_states(port.index(torch.tensor([i]))),
                    tl.pack_states(ts)):
        assert torch.equal(a, b)
    assert int(port_act[i]) == int(act[0])
    want_state, want_feats, want_cand = pallas_leaf_step(
        *jes.pack_states(js), jnp.asarray(act), js.komi, interpret=True)
    got_state, got_feats, got_cand = L.leaf_step(
        *tl.pack_states(ts), torch.from_numpy(act), ts.komi)
    for got, want in zip(got_state, want_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mismatch = np.argwhere(got_feats.numpy() != np.asarray(want_feats))
    assert mismatch.size == 0, mismatch[:20]
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    if case == "wrapped ko":
        assert int(ts.placed_count[0]) > 64
        assert LEAF_KO[case] == KO_RECAPTURE
    if case in LEAF_KO:
        assert got_feats.numpy()[0, 29, LEAF_KO[case]] == 1.0
        assert not got_cand.numpy()[0, LEAF_KO[case]]
    if case == "two-sided capture":   # the corner chain (0,0), (1,0), (0,1)
        assert got_state[0].numpy()[0, 0, [0, 1, 19]].tolist() == [0, 0, 0]
