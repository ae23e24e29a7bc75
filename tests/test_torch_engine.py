"""Port rules engine and state layouts against `dream_go_tpu.go.engine`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.mcts import search as JS
from dream_go_tpu.ops import env_step as jes
from dream_go_torch.go import engine as teng
from dream_go_torch.mcts import search as TS
from dream_go_torch.ops import layout as tl

_jlegal = jax.jit(jax.vmap(jeng.legal_mask))
_jpseudo = jax.jit(jax.vmap(jeng.pseudo_legal_mask))
_jsuperko = jax.jit(jax.vmap(jeng.superko_mask))
_jcand = jax.jit(jax.vmap(lambda s: jeng.candidate_hashes(s, s.to_move)))
_jlibs = jax.jit(jax.vmap(jeng.chain_liberties))
_jstep = jax.jit(jax.vmap(jeng.step))


def test_new_states_match():
    B.assert_states_equal(teng.new_states(3, komi=6.5, device="cpu"),
                          jeng.new_states(3, komi=6.5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_games_match_jax_engine(seed):
    """Random legal games (with passes): every state field, legality,
    super-ko, candidate hashes and liberties agree after every move."""
    rng = np.random.default_rng(seed)
    batch = 4
    js = jeng.new_states(batch)
    ts = teng.new_states(batch, device="cpu")
    for move in range(140):
        legal = np.asarray(_jlegal(js))
        np.testing.assert_array_equal(teng.legal_mask(ts).numpy(), legal)
        if move % 20 == 0:
            np.testing.assert_array_equal(
                teng.pseudo_legal_mask(ts).numpy(), np.asarray(_jpseudo(js)))
            np.testing.assert_array_equal(
                teng.superko_mask(ts).numpy(), np.asarray(_jsuperko(js)))
            np.testing.assert_array_equal(
                teng.candidate_hashes(ts, ts.to_move).numpy()
                .view(np.uint32), np.asarray(_jcand(js)))
            for got, want in zip(
                    teng.chain_liberties(ts.stones, ts.chain_id),
                    _jlibs(js.stones, js.chain_id)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        acts = []
        for b in range(batch):
            pts = np.flatnonzero(legal[b, :361])
            acts.append(361 if len(pts) == 0 or rng.random() < 0.03
                        else int(rng.choice(pts)))
        acts = np.asarray(acts, np.int32)
        js = _jstep(js, jnp.asarray(acts))
        ts = teng.step(ts, torch.from_numpy(acts))
        B.assert_states_equal(ts, js)


def test_pack_states_matches_and_round_trips():
    js = B.random_states(5, [0, 3, 40, 90, 160], 4, pass_prob=0.05)
    ts = B.to_torch(js)
    tp, jp = tl.pack_states(ts), jes.pack_states(js)
    for got, want in zip(tp, jp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tl.unpack_states(ts, *tp)
    B.assert_states_equal(back, jes.unpack_states(js, *jp))


def test_packed_rows_and_candidate_bitsets_match():
    js = B.random_states(4, [0, 20, 70, 130], 6)
    ts = B.to_torch(js)
    tr, jr = TS.pack_rows(ts), JS.pack_rows(js)
    for name, got in tr.fields().items():
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jr, name)), name)
    for got, want in zip(TS._widen_rows(tr), JS._widen_rows(jr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    B.assert_states_equal(TS.unpack_rows(tr), JS.unpack_rows(jr))
    mask = np.asarray(_jlegal(js))
    bits = TS.pack_cand(torch.from_numpy(mask))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(JS.pack_cand(jnp.asarray(mask))))
    np.testing.assert_array_equal(TS.unpack_cand(bits).numpy(), mask)
