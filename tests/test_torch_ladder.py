"""The port's ladder readers (`dream_go_torch.go.ladder`) and the plain
version of its ladder kernel (`ops.ladder_kernel.ladder_planes_plain`)
against the JAX package: its XLA reader (bounded and with raised bounds),
the pure-Python oracle `go.reference.PyBoard`, and on one curated board
the Pallas kernel in interpret mode.  Planes are compared bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
import test_ladder_bounds as LB
import test_ladder_stress as LS
from dream_go_tpu.go import ladder as jl
from dream_go_tpu.ops.env_step import pack_states as jpack
from dream_go_tpu.ops.ladder_kernel import ladder_planes_kernel as jkernel
from dream_go_torch.go import boards as tb
from dream_go_torch.go import ladder as tl
from dream_go_torch.ops import ladder_kernel as tk
from dream_go_torch.ops import layout

BLACK = 1


@functools.lru_cache(maxsize=None)
def _random_boards():
    """Mid-game boards from random legal play; the later ones hold more
    capture starts than the bounded reader's 24."""
    js = B.random_states(6, [40, 80, 120, 160, 200, 240], 5, pass_prob=0.02)
    return js, B.to_torch(js)


def _one(stones, to_move=BLACK):
    """JAX state and port batch of one board from a raw stones list."""
    js = LB.make_state(stones, to_move)
    return js, B.to_torch(jax.tree_util.tree_map(lambda x: x[None], js))


def _batch(ts, exact):
    return tl.ladder_planes_batch(*layout.board_rows(ts), ts.to_move, exact)


def _plain(ts, **kw):
    rows = layout.pack_states(ts)
    return tk.ladder_planes_plain(rows[0], rows[1],
                                  ts.to_move.to(torch.int32), **kw)


@pytest.mark.parametrize("greedy", [True, False])
def test_bounded_readers_match_xla(greedy):
    js, ts = _random_boards()
    want = jax.jit(functools.partial(jl.ladder_planes_batch, greedy=greedy,
                                     use_kernel=False))(js)
    got = _batch(ts, exact=not greedy)
    cap_c, esc_c = tl.candidates(ts)
    assert int(cap_c.sum(1).max()) > 24       # the bound is exercised
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_plain_kernel_version_is_the_uncapped_reader():
    js, ts = _random_boards()
    cap_c, esc_c = tl.candidates(ts)
    want = jax.jit(functools.partial(
        jl.ladder_planes_batch, max_candidates=int(cap_c.sum(1).max()),
        use_kernel=False))(js)
    # the JAX batch reader keeps 8 escape starts; no board here has more
    assert int(esc_c.sum(1).max()) <= 8
    got = _plain(ts)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    bounded = _batch(ts, exact=True)
    assert not torch.equal(got[0], bounded[0])  # the tail past 24 differs


@pytest.mark.parametrize("board", ["capture_swarm", "escape_swarm"])
def test_plain_matches_oracle_and_raised_xla_on_swarms(board):
    stones = getattr(LB, board)()
    js, ts = _one(stones)
    cap, esc = _plain(ts)
    xcap, xesc = jax.jit(functools.partial(
        jl.ladder_planes, max_candidates=64, max_escapes=16))(js)
    np.testing.assert_array_equal(cap[0].numpy(), np.asarray(xcap))
    np.testing.assert_array_equal(esc[0].numpy(), np.asarray(xesc))
    b = LB._board(stones)
    caps, escs = LB._candidates(b)
    ocap, oesc = LB._oracle_planes(b, caps, escs)
    assert len(caps) + len(escs) in (48, 12)
    for p in caps:
        assert bool(cap[0, p]) == ocap[p], p
    for p in escs:
        assert bool(esc[0, p]) == oesc[p], p
    # the bounded reader is the prefix truncation of the same planes
    bcap, besc = tl.ladder_planes(ts)
    for p in caps[24:] + escs[8:]:
        assert not bool(bcap[0, p]) and not bool(besc[0, p])


@pytest.mark.parametrize("which", [0, 1])
def test_plain_matches_oracle_and_raised_xla_on_capture_boards(which,
                                                               monkeypatch):
    """The boards on which a chase captures a third chain mid-ladder
    (`boards.ladder_capture`): black's winning chase from (3, 2), whose
    rung at (7, 9) captures the white stone at (6, 9); an escape at (2, 3)
    refuted by a counter-ladder whose rung captures.  The plain version
    against the raised-bound XLA reader and the oracle on every
    candidate; the port's placements do capture on the way."""
    stones = tb.ladder_capture()[which]
    js, ts = _one(stones)
    removed = []
    place = tl.place_stones

    def counting(st, cid, color, p, libs):
        out = place(st, cid, color, p, libs)
        removed.append(int(((st != 0) & (out[0] == 0)).sum()))
        return out

    monkeypatch.setattr(tl, "place_stones", counting)
    cap, esc = _plain(ts)
    assert sum(removed) > 0
    xcap, xesc = jax.jit(functools.partial(
        jl.ladder_planes, max_candidates=64, max_escapes=16))(js)
    np.testing.assert_array_equal(cap[0].numpy(), np.asarray(xcap))
    np.testing.assert_array_equal(esc[0].numpy(), np.asarray(xesc))
    b = LB._board(stones)
    caps, escs = LB._candidates(b)
    ocap, oesc = LB._oracle_planes(b, caps, escs)
    for p in caps:
        assert bool(cap[0, p]) == ocap[p], p
    for p in escs:
        assert bool(esc[0, p]) == oesc[p], p
    if which == 0:
        assert bool(cap[0, LS.pt(3, 2)]) and bool(cap[0, LS.pt(7, 9)])
    else:
        assert escs == [LS.pt(2, 3), LS.pt(15, 3)]
        assert esc[0].nonzero()[:, 0].tolist() == [LS.pt(15, 3)]


def test_checked_kernel_build_is_a_library_of_its_own():
    """The bounds-checked build (``-DDG_CHECK``) is built beside the
    release one under its own name; on the CPU its wrapper, like the
    kernel's, reads with the plain version."""
    from dream_go_torch.ops import build

    release = build.library_path("ladder_planes")
    checked = build.library_path("ladder_planes", check=True)
    assert release.parent == checked.parent
    assert release.name.startswith("libladder_planes-")
    assert checked.name.startswith("libladder_planes-check-")
    ts = tb.from_stones(tb.ladder_capture(), "cpu")
    rows = layout.pack_states(ts)
    args = rows[0], rows[1], ts.to_move.to(torch.int32)
    got, want = tk.ladder_planes_checked(*args), tk.ladder_planes_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("budget,stack_cap,captured", [
    (None, None, True), (24, None, False), (61, None, False),
    (62, None, True), (None, 0, False), (None, 1, True)])
def test_staircase_bounds_fail_safe(budget, stack_cap, captured):
    """The 31-rung staircase: 62 rungs with alternates; a smaller budget or
    no stack loses the capture, in the port as in the JAX reader."""
    stones = LS.staircase_board()
    js, ts = _one(stones)
    p = LS.pt(3, 2)
    want = bool(jl.is_ladder_capture(js.stones, js.chain_id, BLACK,
                                     jnp.int32(p), budget=budget,
                                     stack_cap=stack_cap))
    got = bool(tl.is_ladder_capture(ts.stones, ts.chain_id, BLACK, p,
                                    budget=budget, stack_cap=stack_cap)[0])
    assert got == want == captured
    kw = {k: v for k, v in (("budget", budget), ("stack_cap", stack_cap))
          if v is not None}
    assert bool(_plain(ts, **kw)[0][0, p]) == captured


@pytest.mark.parametrize("breakers", [((17, 17),), ((12, 13), (16, 17))])
def test_broken_staircase_matches_oracle(breakers):
    stones = LS.staircase_board(breakers=breakers)
    js, ts = _one(stones)
    p = LS.pt(3, 2)
    assert LS.oracle_capture(stones, p, max_depth=10**6) is False
    assert not bool(tl.is_ladder_capture(ts.stones, ts.chain_id, BLACK,
                                         p)[0])
    assert not bool(_plain(ts)[0][0, p])


def test_escape_reader_matches_oracle():
    stones = LB.escape_swarm()
    _, ts = _one(stones)
    b = LB._board(stones)
    escs = LB._candidates(b)[1]
    got = tl.is_ladder_escape(ts.stones.expand(len(escs), -1),
                              ts.chain_id.expand(len(escs), -1), BLACK, escs)
    assert got.tolist() == [b.is_ladder_escape(BLACK, p) for p in escs]


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """One curated board through the Pallas kernel itself: the staircase
    (a 31-rung capture) plus an escape unit in the far corner."""
    stones = LS.staircase_board()
    r, c = 2, 16
    stones[LB.pt(r, c)] = BLACK
    for rc in ((r + 1, c - 2), (r + 1, c + 2)):
        stones[LB.pt(*rc)] = BLACK
    for rc in ((r, c - 1), (r, c + 1), (r - 1, c), (r + 2, c)):
        stones[LB.pt(*rc)] = 2
    js, ts = _one(stones)
    packed = jpack(jax.tree_util.tree_map(lambda x: x[None], js))
    kcap, kesc = jkernel(packed[0], packed[1],
                         js.to_move.astype(jnp.int32)[None], interpret=True)
    cap, esc = _plain(ts)
    np.testing.assert_array_equal(cap.numpy(), np.asarray(kcap))
    np.testing.assert_array_equal(esc.numpy(), np.asarray(kesc))
    assert bool(cap[0, LS.pt(3, 2)])
    assert esc[0].nonzero()[:, 0].tolist() == [LB.pt(r + 1, c)]


def test_stress_boards_are_the_jax_tests_boards():
    """The port's copy of the stress boards (used on the card) is the
    JAX tests' staircase, broken staircase and swarms, chain ids too."""
    want = [LS.staircase_board(), LS.staircase_board(breakers=((17, 17),)),
            LB.capture_swarm(), LB.escape_swarm()]
    got = tb.ladder_stress()
    assert [list(map(int, b)) for b in want] == got
    ts = tb.from_stones(got, "cpu")
    for i, stones in enumerate(want):
        js = LB.make_state(stones)
        np.testing.assert_array_equal(ts.chain_id[i].numpy(),
                                      np.asarray(js.chain_id))
    assert bool(_plain(ts)[0][0, tb.STAIRCASE_START])


def _doomed_escape():
    """The staircase after black's first rung, white to move: white's
    extension at (2, 3) is laddered by the first playable counter-attack
    (right, 60 rungs), so a reader need not try the second (down)."""
    stones = tb.ladder_stress()[0]
    stones[LS.pt(3, 2)] = BLACK
    return tb.from_stones([stones], "cpu", to_move=2)


@pytest.mark.parametrize("which", ["random", "doomed_escape"])
def test_rung_count_stops_each_escape_at_its_first_capture(which):
    """``stats`` counts what the reading needs: each capture start's
    chase, and an escape's counter-attacks in NBR order up to the first
    that captures (counted here one chase at a time)."""
    ts = _random_boards()[1] if which == "random" else _doomed_escape()
    stats = {}
    _plain(ts, stats=stats)
    cap_c, esc_c = tl.candidates(ts)
    want_board, want_rungs, longest, stopped = [], [], 0, 0
    for b in range(ts.batch):
        one = ts.index(torch.tensor([b]))
        color = int(one.to_move[0])
        for p in cap_c[b].nonzero()[:, 0].tolist():
            r = torch.zeros(1, dtype=torch.long)
            tl.run_chases(one.stones, one.chain_id, torch.tensor([color]),
                          torch.tensor([p]), torch.tensor([True]), False,
                          rungs=r)
            want_board.append(b)
            want_rungs.append(int(r))
            longest = max(longest, int(r))
        libs = tl.chain_liberties(one.stones, one.chain_id)[1]
        for p in esc_c[b].nonzero()[:, 0].tolist():
            st2, cid2, feasible, attacks, playable = tl._escape_jobs(
                one.stones, one.chain_id, torch.tensor([color]),
                torch.tensor([p]), libs)
            total = 0
            for k in range(4):
                if not (bool(feasible[0]) and bool(playable[0, k])):
                    continue
                r = torch.zeros(1, dtype=torch.long)
                hit = tl.run_chases(st2, cid2, torch.tensor([3 - color]),
                                    attacks[:, k], torch.tensor([True]),
                                    False, rungs=r)
                total += int(r)
                longest = max(longest, int(r))
                if bool(hit[0]):
                    stopped += k < 3 and bool(playable[0, k + 1:].any())
                    break
            want_board.append(b)
            want_rungs.append(total)
    assert stats["job_board"].tolist() == want_board
    assert stats["job_rungs"].tolist() == want_rungs
    assert stats["longest_chase"] == longest
    if which == "doomed_escape":
        assert stopped == 1 and want_rungs == [60]
