"""The port's closed RL loop against `dream_go_tpu.train.rl_loop`.

Torch's policy sampling and initialisation are not JAX's, so both loops
serve the peaked predictor of `_torch_bridge` (patched over each module's
``net_predictor``), whose single kept action makes policy play equal in
both: two generations, a resume and a warm restart give equal games,
equal balanced pools (the resume's from the refilled replay), equal file
names, step counts and schedules.  Both run at 8 x 1, B = 8, 4 games of
36 moves a generation, 3 train steps, no ex-it, banks of 3 games.  One
run of each package is shared by the module (the JAX loop's compiles take
most of its ~50 s)."""

import os
import re

import jax
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.config import SelfPlayConfig as JSP
from dream_go_tpu.config import TrainConfig as JTC
from dream_go_tpu.selfplay import policy as JPO
from dream_go_tpu.train import rl_loop as JR
from dream_go_torch import cli
from dream_go_torch.config import ModelConfig, SearchConfig, SelfPlayConfig
from dream_go_torch.config import TrainConfig
from dream_go_torch.models import params as MP
from dream_go_torch.train import rl_loop as TR
from dream_go_torch.train.train_loop import Trainer

SIZE = dict(num_channels=8, num_blocks=1, num_samples=2)
LOOP = dict(games_per_generation=4, train_steps_per_generation=3,
            ex_it=False, seed=0, bank_games=3, positions_per_game=4)
#: the three calls of each loop: two generations, a resumed third, then a
#: warm restart that plays a fourth and trains none
CALLS = [dict(generations=2), dict(generations=3, resume=True),
         dict(generations=4, resume=True, warm_restart=True,
              train_steps_per_generation=0)]


def _strip_date(line):
    return re.sub(r"DT\[[^\]]*\]", "", line)


def _run(pkg, out_dir, monkeypatch):
    """The three calls of ``pkg``'s loop into ``out_dir``: per call the
    trainer, its log lines and the pools handed to ``ExampleSource``; and
    the towers the port's actor served."""
    jax_side = pkg is JR
    mod = JR if jax_side else TR
    pred = B.peaked_predictor_jax() if jax_side else B.peaked_predictor_torch()
    towers, pools = [], []

    def serve(*args, **kw):
        towers.append(args[0] if args else None)
        return pred

    source = mod.ExampleSource

    def record(lines, *args, **kw):
        pools[-1].append(list(lines))
        return source(lines, *args, **kw)

    monkeypatch.setattr(mod, "net_predictor", serve)
    monkeypatch.setattr(mod, "ExampleSource", record)
    if jax_side:
        # one compiled policy-play program for every generation (each
        # would otherwise compile its own); the programs are the same
        memo, build = {}, JPO._build_scan_fn

        def scan_fn(player, chunk):
            key = (player.ladder_features, chunk)
            if key not in memo:
                memo[key] = build(player, chunk)
            return memo[key]

        monkeypatch.setattr(JPO, "_build_scan_fn", scan_fn)
        cfgs = (JMC(**SIZE), JTC(batch_size=8),
                JSP(num_games=4, num_rollout=6, max_moves=36),
                JSC(num_rollout=6))
        loop_cfg, kw = JR.RLLoopConfig, {}
    else:
        cfgs = (ModelConfig(**SIZE), TrainConfig(batch_size=8),
                SelfPlayConfig(num_games=4, num_rollout=6, max_moves=36),
                SearchConfig(num_rollout=6))
        loop_cfg, kw = TR.RLLoopConfig, dict(device="cpu")
    out = []
    for call in CALLS:
        logs = []
        pools.append([])
        trainer = mod.run_rl_loop(
            *cfgs, loop_cfg(**dict(LOOP, out_dir=str(out_dir), **call)),
            log_fn=logs.append, **kw)
        out.append((trainer, logs, pools[-1]))
    return out, towers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jdir = tmp_path_factory.mktemp("jax")
        jruns, _ = _run(JR, jdir, mp)
    with pytest.MonkeyPatch.context() as mp:
        tdir = tmp_path_factory.mktemp("torch")
        truns, towers = _run(TR, tdir, mp)
    return dict(jax=(jdir, jruns), torch=(tdir, truns, towers))


def test_balance_games_matches_jax():
    b = "(;GM[1]RE[B+1.5];B[aa])"
    w = "(;GM[1]RE[W+R];B[aa])"
    d = "(;GM[1]RE[0];B[aa])"
    for lines in ([b, b, b, w], [b, b], [w, d, b, w, b], [], [d],
                  [w, w, b, d, b, b, w]):
        assert TR.balance_games(list(lines)) == JR.balance_games(list(lines))
    assert TR.balance_games([b, b]) == [b, b]


def test_games_pools_and_files_match_jax(runs):
    jdir, jruns = runs["jax"]
    tdir, truns, _ = runs["torch"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for gen in range(4):
        name = f"gen_{gen:04d}.sgf"
        with open(tdir / name) as ft, open(jdir / name) as fj:
            got, want = ft.read().splitlines(), fj.read().splitlines()
        assert len(got) == len(want) == 4
        assert [_strip_date(g) for g in got] == [_strip_date(w) for w in want]
    # the balanced pools of every generation; the resumed calls' pools
    # start from the replay refilled from the archived generations
    for (_, _, tpools), (_, _, jpools) in zip(truns, jruns):
        assert len(tpools) == len(jpools)
        for tp, jp in zip(tpools, jpools):
            assert [_strip_date(g) for g in tp] == \
                [_strip_date(g) for g in jp]
    assert [len(p) for _, _, pools in truns for p in pools] == \
        [len(p) for _, _, pools in jruns for p in pools]


def test_steps_resume_and_warm_restart_match_jax(runs):
    _, jruns = runs["jax"]
    _, truns, _ = runs["torch"]
    steps = [(t.step, int(j.state.step))
             for (t, _, _), (j, _, _) in zip(truns, jruns)]
    assert steps == [(6, 6), (9, 9), (9, 9)]
    for (_, tlogs, _), (_, jlogs, _) in zip(truns, jruns):
        for needle in ("resume: generation", "warm restart"):
            assert any(needle in m for m in tlogs) == \
                any(needle in m for m in jlogs)
    assert any("resume: generation 2" in m for m in truns[1][1])
    assert any("resume: generation 3" in m for m in truns[2][1])
    assert any("warm restart" in m for m in truns[2][1])
    t, j = truns[2][0], jruns[2][0]
    assert t.scheduler.learning_rate == j.scheduler.learning_rate \
        == TrainConfig().warm_start_lr
    assert t.scheduler.step == j.scheduler.step == 0


def test_loop_serves_and_dumps_the_raw_parameters(runs):
    """Each generation's actor tower is folded from the learner's raw
    parameters at the generation's start (the previous checkpoint's model,
    not its EMA), in float32 on the CPU, sharing no storage with the
    learner; the weights files hold the raw parameters too."""
    tdir, truns, towers = runs["torch"]
    assert len(towers) == 4
    cfg = ModelConfig(**SIZE)
    for gen in (1, 2):
        ckpt = Trainer.restore(str(tdir / f"ckpt_{gen - 1:04d}"),
                               device="cpu")
        want = MP.fold_train(cfg, ckpt.model.state_dict())
        got = towers[gen].state_dict()
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], want[k].float(), rtol=0,
                                       atol=0)
        ema = MP.fold_train(cfg, {**ckpt.model.state_dict(), **ckpt.ema})
        assert any(not torch.equal(got[k], ema[k].float()) for k in want)
    # generations 0 and 1 served the first call's learner, 2 and 3 the
    # second's and the third's
    for tower, (trainer, _, _) in zip(towers, [truns[0]] + truns):
        learner = {p.data_ptr() for p in trainer.model.parameters()}
        learner |= {b.data_ptr() for b in trainer.model.buffers()}
        assert not learner & {p.data_ptr() for p in tower.parameters()}
    with open(tdir / "weights_0002.json") as fh:
        blob = fh.read()
    with open(tdir / "dream_go.json") as fh:
        latest = fh.read()
    restored = Trainer.restore(str(tdir / "ckpt_0002"), device="cpu")
    assert blob == TR.raw_weights_json(restored)
    assert blob != restored.dump_json()          # the EMA's dump
    with open(tdir / "weights_0003.json") as fh:
        assert latest == fh.read()


def test_cli_loop_resume_and_warm_restart_on_cpu(tmp_path):
    out = str(tmp_path / "rl")
    size = ["--device", "cpu", "--num-channels", "8", "--num-blocks", "1",
            "--num-samples", "2", "--batch-size", "8", "--num-games", "4",
            "--num-rollout", "6", "--max-moves", "36", "--bank-games", "3",
            "--positions-per-game", "4", "--out-dir", out,
            "--ladder-features"]
    assert cli.main(["--loop", "1", *size]) == 0
    ckpt = Trainer.restore(os.path.join(out, "ckpt_0000"), device="cpu")
    assert ckpt.step == 256 and ckpt.model_cfg.ladder_features
    # the checkpoint's contract wins over the flags on resume
    size.remove("--ladder-features")
    assert cli.main(["--loop", "2", "--resume-loop", "--warm-restart",
                     *size]) == 0
    trainer = Trainer.restore(os.path.join(out, "ckpt_0001"), device="cpu")
    assert trainer.step == 512 and trainer.model_cfg.ladder_features
    assert sorted(os.listdir(out)) == [
        "ckpt_0000", "ckpt_0001", "dream_go.json", "gen_0000.sgf",
        "gen_0001.sgf", "weights_0000.json", "weights_0001.json"]
    cfg, _ = MP.load_json(open(os.path.join(out, "weights_0001.json")).read())
    assert (cfg.num_channels, cfg.num_blocks, cfg.ladder_features) == \
        (8, 1, True)


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--policy-play", "2", "--num-games", "2",
                     "--max-moves", "4", "--device", "cpu",
                     "--num-channels", "8", "--num-blocks", "1",
                     "--profile", str(prof)]) == 0
    trace = prof / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()
