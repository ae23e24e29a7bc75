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
from dream_go_torch.ops import layout as tl
from dream_go_torch.ops import leaf_step as L

_P = lambda x, y: 19 * y + x
#: black captures a white stone at (1,1) by playing (2,1): the recapture is
#: a super-ko for white (the position before the capture is in the ring)
KO_MOVES = [_P(1, 0), _P(2, 0), _P(0, 1), _P(3, 1), _P(1, 2), _P(2, 2),
            _P(10, 10), _P(1, 1)]
KO_ACTION = _P(2, 1)


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
    assert got_feats.numpy()[-1, 29, _P(1, 1)] == 1.0
    assert not got_cand.numpy()[-1, _P(1, 1)]
