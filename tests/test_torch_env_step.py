"""Port env_step against the Pallas env_step (interpret mode, given random
words) and the JAX rules engine; the port's own Philox mode against known
answers, legality and the uniform distribution.  The CUDA kernel's own
tests are in test_torch_cuda.py, which imports no JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.ops import env_step as jes
from dream_go_torch.go import engine as teng
from dream_go_torch.go.boards import ENV_CASES, env_cases
from dream_go_torch.ops import env_step as E
from dream_go_torch.ops import layout as tl

_P = lambda x, y: 19 * y + x
#: black captures a white stone at (1,1) by playing (2,1): the recapture is
#: a super-ko for white
KO_MOVES = [_P(1, 0), _P(2, 0), _P(0, 1), _P(3, 1), _P(1, 2), _P(2, 2),
            _P(10, 10), _P(1, 1), _P(2, 1)]
KO_POINT = _P(1, 1)

_jstep = jax.jit(jeng.step_batch)
_jlegal = jax.jit(jeng.legal_mask_batch)


def _assert_rows_equal_jax(ts, js):
    """Every field equal; chain_xor at stones only (the kernel layout
    zeroes it at empty points, the engine may not)."""
    got = B.to_numpy(ts)
    for f in B.FIELDS:
        if f == "chain_xor":
            stone = np.asarray(js.stones) != 0
            np.testing.assert_array_equal(got[f][stone],
                                          np.asarray(js.chain_xor)[stone])
        else:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                          err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_with_given_bits(seed):
    """100 steps at B=6 from fresh boards, uniform weights, the same numpy
    words to both: equal moves and equal states (every field, chain_xor
    included: both keep the kernel layout's zeros) after every step."""
    b, steps = 6, 100
    rng = np.random.default_rng(seed)
    js = jeng.new_states(b)
    ts = B.to_torch(js)
    w = np.ones((b, 361), np.float32)
    w[1, :200] = 0.0                              # a restricted board
    w[2] = rng.random(361).astype(np.float32)     # non-uniform weights
    tw = torch.from_numpy(w)
    for t in range(steps):
        bits = rng.integers(0, 2**32, (b, 361), dtype=np.uint64) \
            .astype(np.uint32)
        js, jmoves = jes.env_step(js, jnp.asarray(w), seed, interpret=True,
                                  use_prng=False,
                                  rng_bits=jnp.asarray(bits))
        ts, tmoves = E.env_step_states(
            ts, tw, seed, rng_bits=torch.from_numpy(bits.view(np.int32)))
        np.testing.assert_array_equal(tmoves.numpy(), np.asarray(jmoves),
                                      err_msg=f"moves at step {t}")
        B.assert_states_equal(ts, js)
    assert (tmoves.numpy() < 361).any()


def _ko_states():
    s = jeng.new_states(1)
    for m in KO_MOVES:
        s = _jstep(s, jnp.asarray([m], jnp.int32))
    return s


def test_onehot_weights_step_like_the_engine():
    """A one-hot weight plays its point; the pass slot (an all-zero row)
    and a super-ko point pass; a finished board stays frozen."""
    js = B.random_states(5, [0, 30, 80, 150, 40], 3)
    js = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), js,
                                _ko_states())
    js = js.replace(done=js.done.at[4].set(True))
    acts = B.legal_actions(js, 5)
    acts[1] = 361
    acts[5] = KO_POINT                       # white's recapture: super-ko
    assert not np.asarray(_jlegal(js))[5, KO_POINT]
    onehot = np.zeros((6, 361), np.float32)
    for g, a in enumerate(acts):
        if a < 361:
            onehot[g, a] = 1.0
    ts, moves = E.env_step_states(B.to_torch(js), torch.from_numpy(onehot), 0)
    want_moves = np.where(acts == KO_POINT, 361, acts)
    want_moves[4] = 361
    np.testing.assert_array_equal(moves.numpy(), want_moves)
    want = _jstep(js, jnp.asarray(want_moves, jnp.int32))
    _assert_rows_equal_jax(ts, want)


def test_weights_respected_and_zero_weights_pass():
    ts = teng.new_states(3, device="cpu")
    w = torch.zeros(3, 361)
    w[0, 72] = 1.0
    w[1, [5, 300]] = torch.tensor([1.0, 1e-30])
    rows, moves = E.env_step(*tl.pack_states(ts), w, 7)
    assert moves.tolist()[0] == 72 and moves.tolist()[1] in (5, 300)
    assert moves.tolist()[2] == 361
    meta = rows[4][:, 0]
    assert meta[:, 3].tolist() == [0, 0, 1]          # pass counts
    assert meta[:, 0].tolist() == [2, 2, 2]          # white to move


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox-4x32-10."""
    m = 0xFFFFFFFF
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((m, m, m, m), (m, m),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = E.philox4x32_10([torch.tensor([c]) for c in ctr],
                              [torch.tensor([k]) for k in key])
        assert [int(g) for g in got] == list(want)


def test_philox_bits_layout():
    """Word q % 4 of the call with counter (move_count, q // 4) and key
    (seed, board)."""
    mc = torch.tensor([0, 17], dtype=torch.int32)
    bits = E.philox_bits(0xdeadbeef, mc)
    assert bits.shape == (2, 361) and bits.dtype == torch.int32
    for b, q in ((0, 0), (1, 5), (1, 360)):
        words = E.philox4x32_10(
            [torch.tensor([int(mc[b])]), torch.tensor([q // 4]),
             torch.tensor([0]), torch.tensor([0])],
            [torch.tensor([0xdeadbeef]), torch.tensor([b])])
        assert int(bits[b, q]) & 0xFFFFFFFF == int(words[q % 4])


def test_philox_mode_legal_and_matches_engine():
    """In-kernel bits: 60 steps at B=8 from fresh boards, every move legal
    under the JAX legality and the state equal to the JAX engine's step
    on those moves; two seeds give different games."""
    b = 8
    js = jeng.new_states(b)
    ts = B.to_torch(js)
    w = torch.ones(b, 361)
    first = {}
    for seed in (3, 4):
        js_s, ts_s = js, ts
        for t in range(60):
            legal = np.asarray(_jlegal(js_s))
            ts_s, moves = E.env_step_states(ts_s, w, seed)
            mv = moves.numpy()
            assert all(legal[g, m] for g, m in enumerate(mv)), t
            js_s = _jstep(js_s, jnp.asarray(mv, jnp.int32))
            _assert_rows_equal_jax(ts_s, js_s)
            first.setdefault(seed, mv)
    assert not np.array_equal(first[3], first[4])


@functools.lru_cache(maxsize=None)
def _first_moves():
    ts = teng.new_states(4096, device="cpu")
    _, moves = E.env_step_states(ts, torch.ones(4096, 361), 11)
    return moves.numpy()


def test_philox_first_move_is_uniform():
    """The first move on 4096 empty boards: chi-square against uniform
    over the 361 points, p > 1e-3."""
    from scipy.stats import chisquare

    counts = np.bincount(_first_moves(), minlength=362)
    assert counts[361] == 0
    assert chisquare(counts[:361]).pvalue > 1e-3


def _to_jax(ts):
    """Port GoState -> JAX GoState (the inverse of ``B.to_torch``)."""
    arrays = B.to_numpy(ts)
    return jeng.new_states(ts.batch).replace(
        **{f: jnp.asarray(arrays[f]) for f in B.FIELDS})


def test_plain_matches_pallas_on_scripted_boards():
    """The CUDA kernel's scripted boards (`boards.ENV_CASES`: a capture
    through two neighbours, suicide, own chains of one and two liberties,
    a merge of three, super-kos in a wrapped ring and through a two-sided
    capture, a ring entry that only the exact compare clears, a finished
    board, a pass slot), one-hot weights and the same numpy words to both,
    in one batch: the port's plain step equals the Pallas kernel in
    interpret mode, and makes each case's move.  The port's engine replays
    the moves to the JAX engine's boards."""
    ts, w, want_moves = env_cases("cpu")
    for i, (_, moves, _, _) in enumerate(ENV_CASES):
        s = jeng.new_states(1)
        for m in moves:
            s = _jstep(s, jnp.asarray([m], jnp.int32))
        got = B.to_numpy(ts.index(torch.tensor([i])))
        for f in ("stones", "chain_id", "hash", "placed_count", "done"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(s, f)))
    js = _to_jax(ts)
    bits = np.random.default_rng(8).integers(
        0, 2**32, (ts.batch, 361), dtype=np.uint64).astype(np.uint32)
    js2, jmoves = jes.env_step(js, jnp.asarray(w.numpy()), 0, interpret=True,
                               use_prng=False, rng_bits=jnp.asarray(bits))
    ts2, tmoves = E.env_step_states(
        ts, w, 0, rng_bits=torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(tmoves.numpy(), np.asarray(jmoves))
    np.testing.assert_array_equal(tmoves.numpy(), want_moves.numpy())
    B.assert_states_equal(ts2, js2)
    names = [c[0] for c in ENV_CASES]
    # the corner chain captured through two of its stones is gone; the
    # finished board stayed as it was
    got = B.to_numpy(ts2)
    assert got["stones"][names.index("two-sided capture"),
                         [0, 1, 19]].tolist() == [0, 0, 0]
    fin = names.index("finished")
    assert got["move_count"][fin] == int(ts.move_count[fin])
    assert int(ts.placed_count[names.index("wrapped ko")]) > 64
