"""The slice as a whole: the port's continuous full-search self-play
against the JAX package's, move for move."""

import re

import numpy as np
import torch

import _torch_bridge as B
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.config import SelfPlayConfig as JSP
from dream_go_tpu.selfplay import records as JR
from dream_go_tpu.selfplay import search_play as JPL
from dream_go_tpu.utils import sgf
from dream_go_tpu.mcts import predictor as JP
from dream_go_tpu.selfplay import policy as JPO
from dream_go_torch import cli
from dream_go_torch.mcts import predictor as TP
from dream_go_torch.selfplay import policy as TPO
from dream_go_torch.utils import sgf as tsgf
from dream_go_torch.config import SearchConfig as TSC
from dream_go_torch.config import SelfPlayConfig as TSP
from dream_go_torch.selfplay import records as TR
from dream_go_torch.selfplay import search_play as TPL


def _strip_date(line):
    return re.sub(r"DT\[[^\]]*\]", "", line)


def test_continuous_self_play_matches_jax():
    """Batch 4, 16 rollouts, greedy moves, 12-move cap, the fused leaf path
    and EARLY-C (the port's defaults on the card): equal SGF lines (moves,
    values, visit targets, result) apart from the date, and every line
    parses with the JAX package's SGF reader."""
    adaptive = True
    kw = dict(num_games=4, num_rollout=16, max_moves=12, temperature_moves=0)
    want = JPL.search_self_play_continuous(
        B.det_predictor_jax(), JSP(**kw),
        JSC(num_rollout=16, dirichlet_noise=0.0, adaptive=adaptive),
        seed=0, batch=4)
    got = TPL.search_self_play_continuous(
        B.det_predictor_torch(), TSP(**kw),
        TSC(num_rollout=16, dirichlet_noise=0.0, fused=True,
            adaptive=adaptive),
        seed=0, batch=4, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _strip_date(g) == _strip_date(w)
        parsed = sgf.parse_line(g)
        assert parsed is not None and len(parsed.moves) >= 12
        for mv in parsed.moves:
            assert mv.num_rollout > 1 and mv.policy is not None


def test_records_match():
    soft = np.linspace(0, 1, 362).astype(np.float32)
    soft /= soft.sum()
    for mv in (dict(to_move=1, point=72, value=0.61, num_rollout=64,
                    softmax=soft), dict(to_move=2, point=361, value=0.2)):
        assert TR.Played(**mv).to_sgf() == JR.Played(**mv).to_sgf()
    terr = np.zeros(361, np.int8)
    terr[:100], terr[200:260] = 1, 2
    assert _strip_date(TR.game_result_sgf(";B[aa]", 7.5, terr)) == \
        _strip_date(JR.game_result_sgf(";B[aa]", 7.5, terr))


def test_cli_self_play_on_cpu(capsys):
    rc = cli.main(["--self-play", "3", "--continuous", "--num-rollout", "4",
                   "--num-games", "2", "--max-moves", "4", "--device", "cpu",
                   "--num-channels", "8", "--num-blocks", "1"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l]
    assert len(lines) == 3
    for line in lines:
        parsed = sgf.parse_line(line)
        assert parsed is not None and len(parsed.moves) >= 4


def test_cli_follows_the_sanity_net_contract():
    """``--weights tests/fixtures/sanity_net.json`` turns planes 30/31 on
    from the net's contract (the CPU reads them greedy) and self-play
    writes well-formed SGF lines; ``--no-ladder-features`` overrides."""
    argv = ["--self-play", "2", "--continuous", "--weights",
            "tests/fixtures/sanity_net.json", "--num-rollout", "8",
            "--num-games", "2", "--max-moves", "6", "--device", "cpu"]
    args = cli.build_parser().parse_args(argv)
    lines = cli.self_play(args)
    assert args.ladder_features is True
    cfg = cli.search_config(args, "cpu")
    assert cfg.ladder_features and cfg.ladders_exact is False
    assert len(lines) == 2
    for line in lines:
        parsed = sgf.parse_line(line)
        assert parsed is not None and len(parsed.moves) >= 6
    off = cli.build_parser().parse_args(argv + ["--no-ladder-features"])
    cli.load_predictor(off, "cpu")
    assert off.ladder_features is False


def test_lockstep_self_play_matches_jax():
    """The lockstep driver, batch 3 played to a 6-move cap, 8 rollouts,
    greedy moves, fresh trees every move (the continuous test covers
    reuse), unfused leaves on the CPU: equal SGF lines."""
    kw = dict(num_games=3, num_rollout=8, max_moves=6, temperature_moves=0)
    want = JPL.search_self_play(
        B.det_predictor_jax(), JSP(**kw),
        JSC(num_rollout=8, dirichlet_noise=0.0, adaptive=False), seed=0,
        tree_reuse=False)
    got = TPL.search_self_play(
        B.det_predictor_torch(), TSP(**kw),
        TSC(num_rollout=8, dirichlet_noise=0.0, fused=False, adaptive=False),
        seed=0, tree_reuse=False, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _strip_date(g) == _strip_date(w)


def test_policy_self_play_matches_jax():
    """Policy play, 4 games to a 40-move cap, with the peaked predictor
    (the percentile cutoff keeps one action, so the two packages' random
    streams draw the same moves): equal SGF lines."""
    cfg = dict(num_games=4, max_moves=40)
    want = JPO.policy_self_play(
        JPO.PolicyPlayer(B.peaked_predictor_jax()), JSP(**cfg), seed=3)
    got = TPO.policy_self_play(
        TPO.PolicyPlayer(B.peaked_predictor_torch()), TSP(**cfg), seed=3,
        device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _strip_date(g) == _strip_date(w)
        assert len(tsgf.parse_line(g).moves) == 40


def test_policy_stagger_matches_jax():
    """Batch 4 staggered over a 30-move game length (slots advance 0, 7,
    15 and 22 moves) with the peaked predictor: equal states."""
    jst = JPL._policy_stagger(
        B.peaked_predictor_jax(), JSP(max_moves=30), JSC(),
        JPL.engine.new_states(4), seed=5)
    tst = TPL._policy_stagger(
        B.peaked_predictor_torch(), TSP(max_moves=30),
        TSC().resolve_auto("cpu"),
        TPL.engine.new_states(4, device="cpu"), seed=5)
    B.assert_states_equal(tst, jst)
    assert tst.move_count.tolist() == [0, 7, 15, 22]


def test_symmetrize_matches_jax():
    """The 8-symmetry average of the deterministic predictor on random
    feature planes: equal values and policies (dyadic numbers: the means
    are exact)."""
    feats = (np.random.default_rng(2).random((3, 19, 19, 32)) < 0.3) \
        .astype(np.float32)
    wv, wp = JP.symmetrize(B.det_predictor_jax())(B.jnp.asarray(feats))
    tv, tp = TP.symmetrize(B.det_predictor_torch())(torch.from_numpy(feats))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))
    # the transforms matter: one symmetry alone gives another policy
    _, one = B.det_predictor_torch()(torch.from_numpy(feats))
    assert not torch.equal(one, tp)


def test_cli_policy_play_and_lockstep_self_play_on_cpu(capsys):
    """``--policy-play N`` and ``--self-play N`` without ``--continuous``
    write N SGF lines that the port's SGF reader parses back."""
    small = ["--num-games", "2", "--max-moves", "5", "--device", "cpu",
             "--num-channels", "8", "--num-blocks", "1"]
    for argv, rollouts in ((["--policy-play", "3"], 1),
                           (["--self-play", "3", "--num-rollout", "4"], 4),
                           (["--self-play", "2", "--num-rollout", "1"], 1)):
        assert cli.main(argv + small) == 0
        lines = [l for l in capsys.readouterr().out.splitlines() if l]
        assert len(lines) == int(argv[1])
        for line in lines:
            parsed = tsgf.parse_line(line)
            assert parsed is not None and len(parsed.moves) == 5
            for mv in parsed.moves:  # policy play writes no TV[]
                if rollouts == 1:
                    assert mv.num_rollout is None
                else:
                    assert 1 < mv.num_rollout <= rollouts


def test_sym_average_policy_player_matches_jax():
    """``PolicyPlayer(sym_average=True)``'s move on random boards: the
    deterministic predictor averaged over the eight symmetries (its dyadic
    means are exact) gives JAX's values and masked policies.  (Whole games
    cannot be compared: on the empty board the average is symmetric, so
    the top moves tie and the two random streams break the tie apart.)"""
    js = B.random_states(4, [0, 9, 40, 120], 4)
    kw = dict(sym_average=True, cutoff_percentile=1.0)
    jfn = JPO._build_move_fn(JPO.PolicyPlayer(B.det_predictor_jax(), **kw))
    _, _, jv, jp = jfn(js, B.jax.random.PRNGKey(0))
    tfn = TPO._build_move_fn(TPO.PolicyPlayer(B.det_predictor_torch(), **kw))
    _, tm, tv, tp = tfn(B.to_torch(js), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    top = tp.max(-1, keepdim=True).values
    assert bool((tp.gather(1, tm.long()[:, None]) == top).all())
    _, _, pv, pp = TPO._build_move_fn(TPO.PolicyPlayer(
        B.det_predictor_torch()))(B.to_torch(js), torch.Generator())
    assert not torch.equal(pp, tp)


def test_sym_average_search_self_play_matches_jax():
    """``search_self_play(sym_average=True)``, batch 2 to a 4-move cap, 6
    rollouts, greedy, the deterministic predictor: equal SGF lines; the
    continuous driver's ``sym_average`` is the symmetrized predictor."""
    kw = dict(num_games=2, num_rollout=6, max_moves=4, temperature_moves=0)
    tcfg = TSC(num_rollout=6, dirichlet_noise=0.0, fused=False,
               adaptive=False)
    want = JPL.search_self_play(
        B.det_predictor_jax(), JSP(**kw),
        JSC(num_rollout=6, dirichlet_noise=0.0, adaptive=False), seed=0,
        sym_average=True, tree_reuse=False)
    got = TPL.search_self_play(B.det_predictor_torch(), TSP(**kw), tcfg,
                               seed=0, sym_average=True, tree_reuse=False,
                               device="cpu")
    assert [_strip_date(g) for g in got] == [_strip_date(w) for w in want]
    run = lambda pred, **sym: [_strip_date(g) for g in
                               TPL.search_self_play_continuous(
                                   pred, TSP(**kw), tcfg, seed=0, batch=2,
                                   device="cpu", **sym)]
    cont = run(B.det_predictor_torch(), sym_average=True)
    assert cont == run(TP.symmetrize(B.det_predictor_torch()))
    assert cont != run(B.det_predictor_torch())
