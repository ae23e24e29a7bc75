"""The program's span recorder (`dream_go_torch/utils/spans.py`) and the
spans of the search, the trainer and the example pipeline: nothing is
recorded and no profiler call is made while tracing is off; spans nest,
carry their parent and request, give self times, close on exceptions,
fall into sessions and share the profiler's clock; and recording changes
no tree of a search and no parameter of a trainer.  All at CPU sizes (a
16 x 2 tower, 4 boards, B = 64)."""

import json
import pathlib
import sys
import threading

import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread)
from dream_go_torch import cli
from dream_go_torch.config import ModelConfig, SearchConfig, TrainConfig
from dream_go_torch.go import engine
from dream_go_torch.mcts import search as S
from dream_go_torch.mcts.predictor import NetPredictor
from dream_go_torch.models import tower as T
from dream_go_torch.train.pipeline import ExampleSource
from dream_go_torch.train.train_loop import Trainer
from dream_go_torch.utils import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAMES = ROOT / "tests" / "fixtures" / "rl20_gen0000_first8.sgf"
SIZE = ModelConfig(num_channels=16, num_blocks=2, num_samples=2,
                   compute_dtype="float32")
TREE_FIELDS = ("root_edge_n", "root_child", "root_edge_w", "slot_action",
               "slot_child", "slot_n", "slot_w", "node_n", "node_w",
               "node_m2", "parent", "parent_action", "parent_slot",
               "node_to_move", "value0", "size", "prior", "cand")


def _no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _events(snap, name):
    return [e for e in snap["events"] if e["name"] == name]


def _states(batch=4, moves=12, seed=5):
    states = engine.new_states(batch, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(moves):
        legal = engine.legal_mask(states).float()
        legal[:, engine.PASS] = 0.0
        states = engine.step(states, torch.multinomial(
            legal, 1, generator=gen)[:, 0].to(torch.int32))
    return states


def _search(states, sims=16, adaptive=False):
    predictor = NetPredictor(T.init_tower(SIZE, seed=3, device="cpu"))
    return S.search(states, predictor, torch.Generator().manual_seed(1),
                    SearchConfig(dirichlet_noise=0.25, fused=True), sims,
                    capacity=sims + 8, adaptive=adaptive)


def test_off_records_nothing_and_enters_no_profiler(monkeypatch):
    _no_record_function(monkeypatch)
    before = spans.snapshot()
    assert not spans.active()
    with spans.span("a", request=1) as s:
        spans.count("c", 3)
        spans.count_device("d", torch.tensor(2))
    assert s is spans.span("b")       # the one shared no-op
    _search(_states(2, 4), sims=3, adaptive=True)
    assert spans.snapshot() == before


def test_nesting_parents_requests_and_self_time(monkeypatch):
    _no_record_function(monkeypatch)  # no profiler: none is opened
    with spans.recording():
        with spans.span("outer", request=7):
            with spans.span("inner"):
                with spans.span("leaf"):
                    pass
            with spans.span("inner", request=8):
                pass
        with spans.span("alone"):
            pass
    snap = spans.snapshot()
    ev = {e["id"]: e for e in snap["events"]}
    outer, = _events(snap, "outer")
    inner = _events(snap, "inner")
    leaf, = _events(snap, "leaf")
    alone, = _events(snap, "alone")
    assert outer["parent"] is None and alone["parent"] is None
    assert [e["parent"] for e in inner] == [outer["id"]] * 2
    assert ev[leaf["parent"]] is inner[0]
    assert [outer["request"], inner[0]["request"], leaf["request"],
            inner[1]["request"], alone["request"]] == [7, 7, 7, 8, None]
    for e in snap["events"]:
        assert e["start_ns"] <= e["end_ns"]
        if e["parent"] is not None:
            p = ev[e["parent"]]
            assert p["start_ns"] <= e["start_ns"] <= e["end_ns"] \
                <= p["end_ns"]
    dur = lambda e: (e["end_ns"] - e["start_ns"]) / 1e9  # noqa: E731
    table = snap["spans"]
    assert table["inner"]["calls"] == 2
    assert table["outer"]["total_s"] == pytest.approx(dur(outer), abs=1e-9)
    assert table["outer"]["self_s"] == pytest.approx(
        dur(outer) - sum(map(dur, inner)), abs=1e-9)
    assert table["inner"]["self_s"] == pytest.approx(
        sum(map(dur, inner)) - dur(leaf), abs=1e-9)
    assert snap["dropped"] == 0


def test_span_closes_on_an_exception():
    with spans.recording():
        with pytest.raises(KeyError):
            with spans.span("outer"):
                with spans.span("raises"):
                    raise KeyError("x")
        with spans.span("after"):
            pass
    snap = spans.snapshot()
    assert snap["spans"]["raises"]["calls"] == 1
    assert snap["spans"]["outer"]["calls"] == 1
    after, = _events(snap, "after")
    assert after["parent"] is None      # nothing left open on the stack


def test_sessions_keep_the_last(monkeypatch):
    with spans.recording():
        with spans.span("first"):
            pass
        spans.count("n", 2)
    with spans.span("off"):
        pass
    with spans.recording():
        with spans.span("second"):
            pass
        spans.count("n", 5)
        spans.count_device("d", torch.tensor(3))
        spans.count_device("d", torch.tensor(4))
    snap = spans.snapshot()
    assert set(snap["spans"]) == {"second"}
    assert snap["counters"] == {"n": 5, "d": 7}
    # a profiler's start after spans ran off begins a session of its own
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("profiled"):
            pass
    assert set(spans.snapshot()["spans"]) == {"profiled"}
    monkeypatch.setattr(spans, "EVENT_CAP", 2)
    with spans.recording():
        for _ in range(5):
            with spans.span("many"):
                pass
    snap = spans.snapshot()
    assert snap["spans"]["many"]["calls"] == 5
    assert len(snap["events"]) == 2 and snap["dropped"] == 3


def test_threads_keep_their_own_stacks():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with spans.span("t"):
                    with spans.span("u"):
                        spans.count("n")

        with spans.recording():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = spans.snapshot()
    assert snap["spans"]["t"]["calls"] == snap["spans"]["u"]["calls"] == 4000
    assert snap["counters"]["n"] == 4000
    ev = {e["id"]: e for e in snap["events"]}
    assert len(ev) == 8000
    assert all(ev[e["parent"]]["name"] == "t" for e in _events(snap, "u"))


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with spans.span("clock.outer", request=k):
                torch.ones(64).sum()
                with spans.span("clock.inner"):
                    torch.ones(64).mul(2)
    snap = spans.snapshot()
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            marks.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in ("clock.outer", "clock.inner"):
        ours = sorted((e["start_ns"], e["end_ns"])
                      for e in _events(snap, name))
        theirs = sorted(marks[name])
        assert len(ours) == len(theirs) == 3
        for (a, b), (c, d) in zip(ours, theirs):
            assert abs(a - c) < 1_000_000 and abs(b - d) < 1_000_000


def test_search_trees_alike_with_recording_on_and_off(monkeypatch):
    states = _states()
    off = _search(states)
    walked = []
    select = S._select_flat

    def keep(*args, **kwargs):
        out = select(*args, **kwargs)
        walked.append(int((out[3][:, 1:] >= 0).sum()))
        return out

    monkeypatch.setattr(S, "_select_flat", keep)
    with spans.recording():
        on = _search(states)
    for f in TREE_FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    for f, v in on.states.fields().items():
        assert torch.equal(v, getattr(off.states, f)), f
    snap = spans.snapshot()
    c = snap["counters"]
    assert len(walked) == c["search.simulations"] == 16
    assert c["search.select.board_levels"] == sum(walked)
    assert c["search.select.lane_trips"] == \
        (c["search.select.iterations"] + 16) * 4
    assert 0 < c["search.select.board_levels"] \
        <= c["search.select.lane_trips"]
    sims = _events(snap, "search.simulation")
    assert [e["request"] for e in sims] == list(range(16))
    ids = {e["id"]: e for e in snap["events"]}
    for name in ("search.select", "search.leaf", "search.net",
                 "search.backup"):
        got = [e for e in _events(snap, name)
               if ids[e["parent"]]["name"] == "search.simulation"]
        assert [e["request"] for e in got] == list(range(16)), name
    root_net, = [e for e in _events(snap, "search.net")
                 if ids[e["parent"]]["name"] == "search.init_trees"]
    for e in _events(snap, "search.select.wait"):
        assert ids[e["parent"]]["name"] == "search.select"
    assert snap["spans"]["search.init_trees"]["calls"] == 1


def _train(steps, record):
    trainer = Trainer.create(SIZE, TrainConfig(batch_size=64), seed=2,
                             device="cpu")
    lines = [ln.strip() for ln in GAMES.read_text().splitlines()
             if ln.strip()]
    source = ExampleSource(lines, 64, seed=4, positions_per_game=8,
                           bank_games=8, device="cpu")
    if record:
        with spans.recording():
            trainer.fit(source, steps, log_every=0)
    else:
        trainer.fit(source, steps, log_every=0)
    return trainer


def test_trainer_alike_with_recording_on_and_off():
    off = _train(3, False)
    on = _train(3, True)
    for (name, a), (_, b) in zip(off.model.state_dict().items(),
                                 on.model.state_dict().items()):
        assert torch.equal(a, b), name
    for name in off.ema:
        assert torch.equal(off.ema[name], on.ema[name]), name
    snap = spans.snapshot()
    ids = {e["id"]: e for e in snap["events"]}
    steps = _events(snap, "train.step")
    assert [e["request"] for e in steps] == [0, 1, 2]
    for name in ("train.forward", "train.backward", "train.update",
                 "train.ema", "train.wait"):
        got = _events(snap, name)
        assert [ids[e["parent"]]["request"] for e in got] == [0, 1, 2], name
        assert all(ids[e["parent"]]["name"] == "train.step" for e in got)
    batches = _events(snap, "pipeline.batch")
    assert len(batches) == 3
    assert all(e["parent"] is None for e in batches)  # closed before yield
    assert snap["spans"]["pipeline.bank"]["calls"] == 1
    assert snap["counters"] == {"train.steps": 3, "pipeline.examples": 192}


def test_trace_cli_prints_the_span_table(capsys):
    """``python -m dream_go_torch.trace`` rehearsed on the CPU: the span
    table of the self-play, then the profile window's."""
    from dream_go_torch import trace

    trace.main(["--device", "cpu", "--games", "2", "--rollouts", "4",
                "--moves", "2", "--channels", "8", "--blocks", "1",
                "--profile-sims", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    table = lines[0]["span_table"]
    assert table["games"] == 2
    assert {"selfplay.move", "selfplay.move.wait", "selfplay.finish_move",
            "search.simulation", "search.select", "search.net",
            "search.backup"} <= set(table["spans"])
    assert table["counters"]["selfplay.moves"] == 2
    for row in table["spans"].values():
        assert 0.0 <= row["self_s"] <= row["total_s"] and row["calls"] > 0
    profile = lines[1]["profile"]
    assert profile["spans"]["search.simulation"]["calls"] == 2
    assert profile["counters"]["search.simulations"] == 2


def test_cli_profile_writes_the_spans(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--self-play", "2", "--continuous", "--num-rollout",
                     "3", "--num-games", "2", "--max-moves", "2",
                     "--device", "cpu", "--num-channels", "8",
                     "--num-blocks", "1", "--profile", str(prof)]) == 0
    snap = json.loads((prof / "spans.json").read_text())
    assert snap["spans"]["selfplay.move"]["calls"] >= 2
    assert snap["counters"]["search.simulations"] > 0
    assert (prof / "trace.json").exists()
