"""Replay, reanalyze and ex-it of the port against
`dream_go_tpu.selfplay.replay` and `.reanalyze`, and the records they
write.

Tolerance: bit-exact everywhere (every field of the replayed states, the
stone snapshots, the leela-zero planes, and the SGF lines byte for byte
with ``DT[]`` stripped), as no bf16 tower runs on the CPU.  Games: the
three of ``tests/fixtures/sample_games.sgf`` and short policy-play games
of the port (peaked predictor).  JAX's annotation pass builds a fresh
search program per call; the tests give both of its calls the same one.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.selfplay import reanalyze as JRA
from dream_go_tpu.selfplay import records as JREC
from dream_go_tpu.selfplay import replay as JR
from dream_go_torch import cli
from dream_go_torch.config import SearchConfig as TSC
from dream_go_torch.config import SelfPlayConfig as TSP
from dream_go_torch.selfplay import reanalyze as TRA
from dream_go_torch.selfplay import records as TREC
from dream_go_torch.selfplay import replay as TR
from dream_go_torch.selfplay.policy import PolicyPlayer, policy_self_play
from dream_go_torch.utils import sgf

REPO = pathlib.Path(__file__).resolve().parents[1]
GAMES = REPO / "tests" / "fixtures" / "sample_games.sgf"


def _strip_date(line):
    return re.sub(r"DT\[[^\]]*\]", "", line)


@functools.lru_cache(maxsize=None)
def policy_lines() -> tuple:
    """Three 40-move policy-play games of the port, the second one marked
    won by resignation."""
    lines = policy_self_play(
        PolicyPlayer(B.peaked_predictor_torch()),
        TSP(num_games=3, max_moves=40), seed=3, device="cpu")
    lines[1] = re.sub(r"RE\[[^\]]*\]", "RE[W+Resign]", lines[1])
    return tuple(lines)


@functools.lru_cache(maxsize=None)
def replay_case():
    """Moves of the sample games and the policy games, padded with passes
    to one length T: ``(moves, lengths, komi, targets)``, targets at 0,
    mid-game and T (the final position) in every row's mix."""
    lines = GAMES.read_text().splitlines() + list(policy_lines())
    games = [sgf.parse_line(line) for line in lines]
    t = max(len(g.moves) for g in games)
    moves = np.full((len(games), t), 361, np.int32)
    for i, g in enumerate(games):
        moves[i, :len(g.moves)] = [m.point for m in g.moves]
    lengths = np.asarray([len(g.moves) for g in games], np.int32)
    komi = np.asarray([g.komi for g in games], np.float32)
    targets = np.asarray([0, 300, t, t, 20, 0], np.int32)
    return moves, lengths, komi, targets


def _tensors(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_states_at_and_final_states_match_jax():
    moves, lengths, komi, targets = replay_case()
    states_at = jax.jit(JR.states_at, static_argnums=3)
    want = states_at(jnp.asarray(moves), jnp.asarray(targets),
                     jnp.asarray(komi), 64)
    m, tg, k, ln = _tensors(moves, targets, komi, lengths)
    B.assert_states_equal(TR.states_at(m, tg, k), want)
    # final_states is states_at at the games' lengths
    want = states_at(jnp.asarray(moves), jnp.asarray(lengths),
                     jnp.asarray(komi), 64)
    B.assert_states_equal(TR.final_states(m, ln, k), want)
    # no final position asked for: the replay stops at the largest target
    early = np.minimum(targets, 300)
    want = states_at(jnp.asarray(moves), jnp.asarray(early),
                     jnp.asarray(komi), 64)
    B.assert_states_equal(TR.states_at(m, torch.from_numpy(early), k), want)


def test_states_at_multi_matches_jax():
    moves, _, komi, targets = replay_case()
    multi = np.stack([targets, np.roll(targets, 1), np.roll(targets, 3)], 1)
    want = jax.jit(JR.states_at_multi, static_argnums=3)(
        jnp.asarray(moves), jnp.asarray(multi), jnp.asarray(komi), 64)
    m, tg, k = _tensors(moves, multi, komi)
    got = TR.states_at_multi(m, tg, k)
    assert got.stones.shape == (6, 3, 361)
    for f in B.FIELDS:
        a = getattr(got, f).numpy()
        if f in B.U32_FIELDS:
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_stone_history_and_lz_features_match_jax():
    moves, _, komi, targets = replay_case()
    want, want_hist = jax.jit(JR.states_and_stone_history_at,
                              static_argnums=(3, 4))(
        jnp.asarray(moves), jnp.asarray(targets), jnp.asarray(komi), 64, 8)
    m, tg, k = _tensors(moves, targets, komi)
    got, hist = TR.states_and_stone_history_at(m, tg, k)
    B.assert_states_equal(got, want)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    assert (hist[1:3, 1:].abs().sum((1, 2)) > 0).all()
    np.testing.assert_array_equal(
        TR.lz_features(got, hist).numpy(),
        np.asarray(jax.vmap(JR.lz_features)(want, want_hist)))


# ---------------------------------------------------------------------------
# records


def test_records_with_prior_point_explain_and_resign_match_jax():
    soft = np.linspace(0, 1, 362).astype(np.float32)
    soft /= soft.sum()
    for mv in (dict(to_move=1, point=72, value=0.61, num_rollout=64,
                    softmax=soft, prior_point=100,
                    explain="D4:12(0.55)\nQ16:3(0.41)"),
               dict(to_move=2, point=361, value=0.2, prior_point=0),
               dict(to_move=2, point=5, explain="x")):
        assert TREC.Played(**mv).to_sgf() == JREC.Played(**mv).to_sgf()
    terr = np.zeros(361, np.int8)
    terr[:100], terr[200:260] = 1, 2
    for kw in (dict(resign_winner=1), dict(resign_winner=2),
               dict(territory=terr, resign_winner=2), dict(territory=terr)):
        assert _strip_date(TREC.game_result_sgf(";B[aa]", 6.5, **kw)) == \
            _strip_date(JREC.game_result_sgf(";B[aa]", 6.5, **kw))


# ---------------------------------------------------------------------------
# reanalyze and ex-it


@pytest.fixture(scope="module")
def jax_annotated():
    """JAX's reanalyze and ex-it lines of the policy games, noise off,
    chunks of 8 positions; both calls share one compiled search."""
    build = functools.lru_cache(maxsize=None)(JRA._build_search_fn)
    lines = list(policy_lines())
    cfg, predictor = JSC(dirichlet_noise=0.0), B.det_predictor_jax()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRA, "_build_search_fn", build)
        out = {name: fn(lines, predictor, cfg, num_sims=16,
                        fraction=0.15, seed=4, position_batch=8)
               for name, fn in (("reanalyze", JRA.reanalyze),
                                ("ex_it", JRA.ex_it))}
    assert build.cache_info().currsize == 1
    return out


def _patched(lines, sims):
    return {(gi, mi) for gi, line in enumerate(lines)
            for mi, mv in enumerate(sgf.parse_line(line).moves)
            if mv.num_rollout == sims}


@pytest.mark.parametrize("name", ["reanalyze", "ex_it"])
def test_annotated_lines_match_jax(jax_annotated, name):
    want = jax_annotated[name]
    got = getattr(TRA, name)(
        list(policy_lines()), B.det_predictor_torch(),
        TSC(dirichlet_noise=0.0), num_sims=16, fraction=0.15, seed=4,
        position_batch=8, device="cpu")
    assert [_strip_date(g) for g in got] == [_strip_date(w) for w in want]
    patched = _patched(got, 16)
    assert patched == _patched(want, 16)
    # more than one chunk, the last one padded
    assert len(patched) > 8 and len(patched) % 8
    assert "RE[W+Resign]" in got[1]


def test_nothing_drawn_returns_the_lines():
    lines = list(policy_lines())
    assert TRA.reanalyze(lines, B.det_predictor_torch(), num_sims=16,
                         fraction=0.0, device="cpu") == lines


# ---------------------------------------------------------------------------
# the CLI at 16 x 2 (4 rollouts: the plain features of a CPU search cost
# ~0.8 s a call at the annotation pass's batch of 64)


SMALL = ["--device", "cpu", "--num-channels", "16", "--num-blocks", "2",
         "--num-rollout", "4"]


@pytest.mark.parametrize("ex_it", [False, True])
def test_cli_reanalyze(tmp_path, capsys, ex_it):
    path = tmp_path / "games.sgf"
    path.write_text("\n".join(policy_lines()) + "\n")
    argv = ["--reanalyze", str(path)] + SMALL + (["--ex-it"] if ex_it
                                                 else [])
    assert cli.main(argv) == 0
    out = [line for line in capsys.readouterr().out.splitlines() if line]
    assert len(out) == 3
    patched = 0
    for line in out:
        game = sgf.parse_line(line)
        assert game is not None and len(game.moves) == 40
        for mv in game.moves:
            if mv.num_rollout == 4:
                patched += 1
                assert mv.policy is not None and mv.policy.shape == (362,)
    assert patched > 0


@pytest.mark.parametrize("continuous", [False, True])
def test_cli_self_play_ex_it(capsys, continuous):
    """Self-play, then the ex-it pass over its games (seed 1 draws
    positions from both drivers' games)."""
    argv = ["--self-play", "2", "--ex-it", "--num-games", "2",
            "--max-moves", "12", "--seed", "1"] + SMALL + (
                ["--continuous"] if continuous else [])
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRA, "_search_positions", lambda *a: calls.append(
            a[0].batch) or _search_positions(*a))
        assert cli.main(argv) == 0
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("(")]
    assert len(out) == 2 and calls == [64]
    for line in out:
        game = sgf.parse_line(line)
        assert game is not None and len(game.moves) >= 12


_search_positions = TRA._search_positions
