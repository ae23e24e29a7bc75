"""``BENCHMARK.json`` against the rules of its format, and the cell files
it names."""

from __future__ import annotations

import json
import re

import pytest

from bench_port import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in M["end_to_end"]}


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check():
    runs = 2 + 14 * 24
    total = runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"]
                         + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("bench_port/configs/")
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in M["workloads"])
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    assert (harness.HERE / "runners" / f"{traffic['runner']}.py").exists()
    reported = {m["name"] for m in harness.metrics_of(cell["name"], False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_of(cell["name"], True)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("metric", M["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()


def test_setup_s_is_there():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_every_listed_cell_reports(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["moves"] in E2E
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", [w["name"] for w in M["workloads"]]):
        assert cell in [w["name"] for w in M["workloads"]]
        assert "workloads" not in moved or cell in moved["workloads"]
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(TEXT.match(layer) for layer in layers)
    # every cell carries a whole-step share of the peak beside its rooflines
    for cell in M["workloads"]:
        names = [m["name"] for m in harness.metrics_of(cell["name"], True)]
        if any(n.endswith("_roofline") for n in names):
            assert any("mfu" in n for n in names)
