"""The port's self-play worker and trainer over shared storage
(`dream_go_torch/distr_env/`) against the JAX side's files
(`contrib/distr-env/`): the storage contract beside JAX's copy, loaded by
path; a CPU round trip at 8 x 1 (a worker round, a trainer generation, a
search-mode worker round on its weights, a resumed trainer generation, a
worker round that picks up generation 1); the published weights decoded
by JAX's ``load_json``; the games parsed by JAX's SGF reader; JAX's
``dump_json`` weights served by the port's worker; and the CLI loop's
``--steps-per-gen``, named after the trainer's."""

import contextlib
import importlib.util
import io
import os
import pathlib

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a test process)
from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.models import params as JP
from dream_go_tpu.utils import sgf as jsgf
from dream_go_torch.config import ModelConfig
from dream_go_torch.distr_env import dg_storage as tst
from dream_go_torch.distr_env import run_train, run_worker
from dream_go_torch.models import params as TP
from dream_go_torch.models import tower as TT
from dream_go_torch.utils import sgf as tsgf

ROOT = pathlib.Path(__file__).resolve().parents[1]
NET = ["--num-channels", "8", "--num-blocks", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def jst():
    spec = importlib.util.spec_from_file_location(
        "jax_dg_storage", ROOT / "contrib" / "distr-env" / "dg_storage.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _listing(root) -> dict:
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in ("weights", "games")}


def test_storage_matches_jax(jst, tmp_path):
    """The same calls on both copies: the same file names, listing,
    latest generation and fresh games, and no temporary file left; then
    each side reads the other's root."""
    roots = {}
    for name, st in (("jax", jst), ("port", tst)):
        root = str(tmp_path / name)
        got = [st.latest_weights(root)[0]]
        for gen in (3, 0, 12):
            st.publish_weights(root, gen, f'{{"gen": {gen}}}')
        got.append(st.latest_weights(root)[0])
        st.append_games(root, "w1", 0, ["(;B[aa])", "(;B[bb])"])
        st.append_games(root, "w0", 7, ["(;B[cc])"])
        fresh, seen = st.new_games(root, set())
        st.append_games(root, "w0", 8, ["(;B[dd])", ""])
        fresh2, seen2 = st.new_games(root, seen)
        got += [fresh, sorted(seen), fresh2, sorted(seen2)]
        roots[name] = (root, got)
    (jroot, jgot), (troot, tgot) = roots["jax"], roots["port"]
    assert tgot == jgot
    assert jgot[:2] == [-1, 12]
    assert jgot[2] == ["(;B[cc])", "(;B[aa])", "(;B[bb])"]
    assert _listing(troot) == _listing(jroot)
    for root in (jroot, troot):
        for d in ("weights", "games"):
            assert not [n for n in os.listdir(os.path.join(root, d))
                        if n.endswith(".tmp")]
    assert tst.latest_weights(jroot)[1].endswith("weights_000012.json")
    assert tst.new_games(jroot, set())[0] == jst.new_games(troot, set())[0]


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """A policy-play round on a random net, a trainer generation, a
    search-mode round, a resumed trainer generation, a policy-play round
    (games of 32 moves or more are the trainer's examples)."""
    root = str(tmp_path_factory.mktemp("distr"))
    r = ["--root", root] + NET
    train = ["--batch-size", "4", "--steps-per-gen", "2",
             "--min-new-games", "2", "--rounds", "1"]
    logs = [
        _run(run_worker.main, r + ["--games", "2", "--rounds", "1",
                                   "--max-moves", "32", "--seed", "3",
                                   "--worker-id", "w0"]),
        _run(run_train.main, r + train),
        _run(run_worker.main, r + ["--games", "2", "--rounds", "1",
                                   "--max-moves", "6", "--num-rollout", "4",
                                   "--worker-id", "w1"]),
        _run(run_train.main, r + train),
        _run(run_worker.main, r + ["--games", "2", "--rounds", "1",
                                   "--max-moves", "4", "--seed", "4",
                                   "--worker-id", "w2"]),
    ]
    return root, logs


def test_round_trip(round_trip):
    root, logs = round_trip
    assert "weights generation -1" in logs[0]
    assert "trainer: gen 0 " in logs[1]
    assert "weights generation 0" in logs[2] and "2 games" in logs[2]
    assert "trainer: resumed from" in logs[3] and "trainer: gen 1 " in logs[3]
    assert "weights generation 1" in logs[4]
    assert _listing(root) == {
        "weights": ["weights_000000.json", "weights_000001.json"],
        "games": ["w0_000000.sgf", "w1_000000.sgf", "w2_000000.sgf"]}
    assert os.path.isfile(os.path.join(root, run_train.CHECKPOINT))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_published_weights_decode_alike_in_jax(round_trip):
    root, _ = round_trip
    for name in sorted(os.listdir(os.path.join(root, "weights"))):
        with open(os.path.join(root, "weights", name)) as fh:
            text = fh.read()
        tcfg, tparams = TP.load_json(text)
        jcfg, jparams = JP.load_json(text)
        assert (tcfg.num_channels, tcfg.num_blocks, tcfg.ladder_features) \
            == (jcfg.num_channels, jcfg.num_blocks, jcfg.ladder_features) \
            == (8, 1, False)
        tflat, jflat = _flat(tparams), _flat(jparams)
        assert sorted(tflat) == sorted(jflat)
        for k in tflat:
            np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


def test_games_parse_in_jax(round_trip):
    root, _ = round_trip
    lines = tst.new_games(root, set())[0]
    assert len(lines) == 6
    for line in lines:
        j, t = jsgf.parse_line(line), tsgf.parse_line(line)
        assert j is not None and t is not None
        assert [(m.color, m.point) for m in j.moves] == \
            [(m.color, m.point) for m in t.moves]
        assert (j.komi, j.winner) == (t.komi, t.winner)


def test_worker_serves_jax_dumped_weights(jst, tmp_path):
    """A planes-on 8 x 1 net written by JAX's ``dump_json`` and published
    by JAX's storage: the port's worker loads it (its contract turns planes
    30/31 on) and plays a round from it."""
    cfg = ModelConfig(num_channels=8, num_blocks=1, ladder_features=True)
    sd = TT.init_train_tower(cfg, seed=5, device="cpu").state_dict()
    text = JP.dump_json(JMC(num_channels=8, num_blocks=1,
                            ladder_features=True),
                        *TP.to_train_tree(cfg, sd))
    root = str(tmp_path)
    path = jst.publish_weights(root, 5, text)
    args = run_worker.build_parser().parse_args(["--root", root] + NET)
    _, ladders = run_worker.build_predictor(path, args, torch.device("cpu"))
    assert ladders
    log = _run(run_worker.main, ["--root", root, "--games", "2", "--rounds",
                                 "1", "--max-moves", "6"] + NET)
    assert "weights generation 5" in log
    assert len(tst.new_games(root, set())[0]) == 2


def test_cli_loop_steps_per_gen(monkeypatch):
    """``--steps-per-gen`` (as `run_train`'s) sets the loop's train steps
    a generation; unset, the loop keeps its 256."""
    from dream_go_torch import cli
    from dream_go_torch.train import rl_loop

    seen = []
    monkeypatch.setattr(rl_loop, "run_rl_loop",
                        lambda *a, **kw: seen.append(a[4]))
    for extra, want in (([], 256), (["--steps-per-gen", "3"], 3)):
        assert cli.main(["--loop", "1", "--device", "cpu", *extra]) == 0
        assert seen[-1].train_steps_per_generation == want
    assert rl_loop.RLLoopConfig().train_steps_per_generation == 256
