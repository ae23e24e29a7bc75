"""The slice as a whole: the port's continuous full-search self-play
against the JAX package's, move for move."""

import re

import numpy as np

import _torch_bridge as B
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.config import SelfPlayConfig as JSP
from dream_go_tpu.selfplay import records as JR
from dream_go_tpu.selfplay import search_play as JPL
from dream_go_tpu.utils import sgf
from dream_go_torch import cli
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
