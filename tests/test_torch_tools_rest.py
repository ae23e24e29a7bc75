"""The rest of the port's tools (`dream_go_torch/tools/`) against the JAX
package's (`tools/`, loaded by file path): ``sgf2stats`` and
``sgf2cgoban`` byte for byte, ``sgf2array``'s arrays, the fuzzer's
command stream (recorded by a fake engine) and the fuzzer over the port's
engine, ``tune``'s refusal and one tiny match, and CPU rehearsals of the
measurement tools at tiny sizes, each printing the JAX tool's keys."""

import ast
import contextlib
import functools
import importlib.util
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a test process)
from dream_go_torch.distr_env import run_train, run_worker
from dream_go_torch.tools import (bench_selfplay, fuzz2gtp,
                                  ladder_differential, measure_eval_dupes,
                                  measure_ladder_cost, measure_ladder_greedy,
                                  profile_flat, profile_ladder, sgf2array,
                                  sgf2cgoban, sgf2stats, tune)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAMPLES = ROOT / "tests" / "fixtures" / "sample_games.sgf"
TINY = ["--channels", "8", "--blocks", "1", "--device", "cpu"]


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stdout(fn, stdin_text=None, monkeypatch=None, argv=None) -> str:
    """``fn()``'s stdout, with stdin (and ``sys.argv``) set."""
    out = io.StringIO()
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn()
    assert not rc
    return out.getvalue()


@pytest.mark.parametrize("name,port", [("sgf2stats", sgf2stats),
                                       ("sgf2cgoban", sgf2cgoban)])
def test_text_tools_byte_equal(name, port, monkeypatch):
    text = SAMPLES.read_text()
    want = _stdout(_jax_tool(name).main, text, monkeypatch)
    got = _stdout(lambda: port.main(["--device", "cpu"]), text, monkeypatch)
    assert got == want and len(want) > 100


def test_sgf2array_matches_jax(tmp_path, monkeypatch):
    """The first two sample games: every array and key of the JAX tool's
    ``.npz``."""
    text = "".join(SAMPLES.read_text().splitlines(True)[:2])
    jout, tout = tmp_path / "jax.npz", tmp_path / "port.npz"
    _stdout(_jax_tool("sgf2array").main, text, monkeypatch,
            ["sgf2array.py", str(jout)])
    _stdout(lambda: sgf2array.main([str(tout), "--device", "cpu"]), text,
            monkeypatch)
    want, got = np.load(jout), np.load(tout)
    assert sorted(got.files) == sorted(want.files) and len(want.files) == 10
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class Recorder:
    """A GTP engine that answers ``=`` and keeps every command."""

    def __init__(self, *args, **kw):
        self.lines = []
        Recorder.last = self

    def ask(self, line):
        self.lines.append(line)
        return "= "


def test_fuzz_stream_matches_jax(monkeypatch):
    jtool = _jax_tool("fuzz2gtp")
    monkeypatch.setattr(jtool, "InProcess", Recorder)
    _stdout(jtool.main, argv=["fuzz2gtp.py", "--moves", "30", "--seed", "7"],
            monkeypatch=monkeypatch)
    want = Recorder.last.lines
    port = Recorder()
    assert fuzz2gtp.fuzz(port, 30, 7, log=lambda msg: None) == (len(want), 0)
    assert port.lines == want
    assert sum(line.startswith("genmove") for line in want) == 30


def test_fuzz_port_engine():
    """The port's engine at 16 x 1, 20 genmoves: no malformed answer."""
    line = json.loads(_stdout(lambda: fuzz2gtp.main(
        ["--moves", "20", "--num-channels", "16", "--num-blocks", "1",
         "--device", "cpu"])).splitlines()[-1])
    assert line["failures"] == 0 and line["genmoves"] == 20


def test_tune_refuses_softmax_temperature():
    with pytest.raises(SystemExit) as err, \
            contextlib.redirect_stderr(io.StringIO()) as msg:
        tune.main(["--param", "SOFTMAX_TEMPERATURE", "--device", "cpu"])
    assert err.value.code == 2 and "tunes nothing" in msg.getvalue()
    with pytest.raises(ValueError, match="tunes nothing"):
        tune.cfg_with("softmax_temperature", 1.0, "cpu")


def test_tune_match():
    wins = tune.play_match(1.2, 1.6, "FPU_REDUCE", 2, 4, seed=0,
                           device="cpu", max_moves=6)
    assert 0 <= wins <= 2
    assert tune.cfg_with("UCT_EXP", 1.25, "cpu").uct_exp.knots == \
        ((0.0, 1.25),)


def _dict_keys(tool: str) -> list[str]:
    """The keys of the largest dict literal in the JAX tool."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    return [k.value for k in max(dicts, key=lambda d: len(d.keys)).keys]


def _timed_names(tool: str) -> list[str]:
    """The names the JAX tool times (``timeit("name", ...)``) and the
    keys it sets (``out["key"] = ...``)."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    names = [n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", "")
             == "timeit"]
    names += [t.slice.value for n in ast.walk(tree)
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Subscript) and getattr(t.value, "id", "")
              == "out" and isinstance(t.slice, ast.Constant)]
    return names


#: the JAX profile_flat / profile_sim_phases names the port renames
FLAT_RENAMED = {"fused_full": "full", "no_insert_ctx": "no_insert",
                "xla_full": "unfused"}

REHEARSALS = {
    "bench_selfplay": (bench_selfplay.main, TINY + [
        "--batch", "2", "--rollout", "4", "--games", "2", "--warmup-games",
        "1", "--max-moves", "6"]),
    "profile_flat": (profile_flat.main, TINY + [
        "--batch", "2", "--capacity", "33", "--sims", "2", "--repeat", "1"]),
    "profile_ladder": (profile_ladder.main, TINY + [
        "--batch", "3", "--depth", "30", "--repeats", "1", "--sims", "2"]),
    "measure_ladder_cost": (measure_ladder_cost.main, TINY + [
        "--batch", "2", "--sims", "2", "--reps", "1"]),
    "measure_ladder_greedy": (measure_ladder_greedy.main, [
        "--points", "10", "--batch", "4", "--depths", "20", "60",
        "--device", "cpu"]),
    "measure_eval_dupes": (measure_eval_dupes.main, [
        "--games", "3", "--sims", "6", "--moves", "4", "--channels", "8",
        "--blocks", "1", "--device", "cpu"]),
}


@pytest.mark.parametrize("name", sorted(REHEARSALS))
def test_rehearsal_prints_jax_keys(name):
    main, argv = REHEARSALS[name]
    lines = _stdout(lambda: main(argv)).splitlines()
    last = json.loads(lines[-1])
    text = "\n".join(lines)
    if name in ("bench_selfplay", "measure_ladder_cost"):
        assert set(_dict_keys(name)) <= set(last)
        assert all(last[k] is not None for k in _dict_keys(name)
                   if k != "games_per_sec_steady")
    elif name == "profile_flat":
        want = {FLAT_RENAMED.get(k, k) for k in
                _timed_names("profile_flat") + _timed_names(
                    "profile_sim_phases")}
        assert want <= set(last) and len(want) == 11
        assert all(last[k] > 0 for k in profile_flat.VARIANTS)
    elif name == "profile_ladder":
        for pat in (r"^device: cpu$",
                    r"^ladder_planes\[greedy\] batch 3: [\d.]+ ms/batch",
                    r"^ladder_planes\[exact\] batch 3: [\d.]+ ms/batch",
                    r"^search\[ladders=off\] batch 3 x 2 sims: [\d,]+ "
                    r"sims/s", r"^search\[ladders=exact\] batch 3"):
            assert re.search(pat, text, re.M), pat
    elif name == "measure_ladder_greedy":
        assert re.search(r"^agreement: \d+/\d+ = [\d.]+%$", text, re.M)
        assert re.search(r"^(PASS|FAIL) ", text, re.M)
        assert last["points"] >= 10
    else:
        assert re.search(r"^leaf evaluations: 18; repeated board hashes "
                         r"\(would-be cache hits\): \d+ \([\d.]+%\)$", text,
                         re.M)


@pytest.mark.parametrize("main", [
    bench_selfplay.main, fuzz2gtp.main, ladder_differential.main,
    measure_eval_dupes.main, measure_ladder_cost.main,
    measure_ladder_greedy.main, profile_flat.main, profile_ladder.main,
    sgf2array.main, sgf2cgoban.main, sgf2stats.main, tune.main,
    run_train.main, run_worker.main])
def test_cuda_default_raises_without_a_card(main, monkeypatch, tmp_path):
    """Every new entry point defaults to the card and raises where there
    is none (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--root", str(tmp_path)] if main in (run_train.main,
                                                 run_worker.main) else []
    with pytest.raises(RuntimeError, match="no card"):
        main(argv)


def test_plot_metrics_reads_the_ports_metrics(tmp_path, monkeypatch):
    """`tools/plot_metrics.py` (it imports nothing of JAX) reads the
    port's ``--metrics`` file unchanged: a line per numeric series, the
    trainer's loss among them, with one value a step."""
    from dream_go_torch import cli

    path = tmp_path / "m.jsonl"
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main([
            "--start", str(ROOT / "tests" / "fixtures" /
                           "rl20_gen0000_first8.sgf"),
            "--steps", "3", "--device", "cpu", "--num-channels", "8",
            "--num-blocks", "1", "--batch-size", "8",
            "--positions-per-game", "4", "--bank-games", "3", "--metrics",
            str(path)]) == 0
    out = _stdout(_jax_tool("plot_metrics").main, argv=[
        "plot_metrics.py", str(path)], monkeypatch=monkeypatch)
    rows = {line.split()[0]: line for line in out.splitlines()}
    keys = set(json.loads(path.read_text().splitlines()[0])) - {"time"}
    assert set(rows) == keys and "loss" in rows
    assert all(" n=     3 " in line for line in rows.values())
