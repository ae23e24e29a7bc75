"""Helpers shared by the port's parity tests: move board states between the
JAX package and the PyTorch port as numpy arrays, and play random legal
games with the JAX engine."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dream_go_tpu.go import engine as jeng
from dream_go_torch.go import engine as teng

# the suite runs several test processes side by side: one intra-op thread
# each keeps torch's CPU kernels from oversubscribing the cores (and from
# slowing the other processes' tests)
torch.set_num_threads(1)

U32_FIELDS = ("chain_xor", "hash", "hash_hist")
FIELDS = ("stones", "chain_id", "chain_xor", "to_move", "hash", "hash_hist",
          "placed_count", "move_count", "pass_count", "last_two", "komi",
          "done")


def to_torch(js) -> teng.GoState:
    """JAX GoState (batched) -> port GoState on the CPU."""
    kw = {}
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        if f in U32_FIELDS:
            a = a.view(np.int32)
        kw[f] = torch.from_numpy(a.copy())
    return teng.GoState(**kw)


def to_numpy(ts: teng.GoState) -> dict:
    """Port GoState -> numpy arrays with the JAX package's dtypes."""
    out = {}
    for f, v in ts.fields().items():
        a = v.cpu().numpy()
        out[f] = a.view(np.uint32) if f in U32_FIELDS else a
    return out


def assert_states_equal(ts: teng.GoState, js):
    got = to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f)


_step = jax.jit(jax.vmap(jeng.step))
_legal = jax.jit(jax.vmap(jeng.legal_mask))


def random_states(batch: int, moves, seed: int, pass_prob: float = 0.0):
    """JAX states after random legal play; ``moves`` is an int or a
    per-board list (boards stop at their own move count)."""
    rng = np.random.default_rng(seed)
    target = np.broadcast_to(np.asarray(moves), (batch,))
    states = jeng.new_states(batch)
    for i in range(int(target.max())):
        mask = np.asarray(_legal(states))
        mv = []
        for b in range(batch):
            if i >= target[b]:
                mv.append(-1)
                continue
            choices = np.flatnonzero(mask[b, :361])
            if len(choices) == 0 or rng.random() < pass_prob:
                mv.append(361)
            else:
                mv.append(int(rng.choice(choices)))
        mv = np.asarray(mv)
        stepped = _step(states, jnp.asarray(np.maximum(mv, 0), jnp.int32))
        keep = jnp.asarray(mv < 0)
        states = jax.tree_util.tree_map(
            lambda old, new: jnp.where(
                keep.reshape((batch,) + (1,) * (old.ndim - 1)), old, new),
            states, stepped)
    return states


def legal_actions(js, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = np.asarray(_legal(js))
    return np.asarray([rng.choice(np.flatnonzero(m)) for m in mask],
                      np.int32)


_W = (np.arange(19 * 19 * 32).reshape(19, 19, 32) % 7 + 1).astype(np.int32)


def det_predictor_jax():
    """The deterministic predictor of the search parity tests, defined the
    same way in both packages: a hash of the feature bits picks dyadic
    policy entries (their float32 sums are exact in any order) and a
    dyadic value, so both searches see identical numbers."""
    w = jnp.asarray(_W)

    def predict(feats):
        bits = (feats > 0.5).astype(jnp.int32)
        h = jnp.sum(bits * w, axis=(1, 2, 3))
        a = jnp.arange(362, dtype=jnp.int32)
        k = (h[:, None] * 31 + a[None, :] * 17) % 251 + 1
        value = ((h % 200) + 28).astype(jnp.float32) / 256.0
        return value, k.astype(jnp.float32) / 4096.0

    return predict


def det_predictor_torch():
    """:func:`det_predictor_jax` for the port."""
    from dream_go_torch.mcts.predictor import Predictor

    w = torch.from_numpy(_W)

    def predict(feats):
        bits = (feats > 0.5).to(torch.int32)
        h = (bits * w.to(feats.device)).sum(dim=(1, 2, 3))
        a = torch.arange(362, dtype=torch.int32, device=feats.device)
        k = (h[:, None] * 31 + a[None, :] * 17) % 251 + 1
        value = ((h % 200) + 28).to(torch.float32) / 256.0
        return value, k.to(torch.float32) / 4096.0

    return Predictor(predict)
