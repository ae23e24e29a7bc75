"""The per-layer metrics read from the program's own span store: a traced
run of each cell at a CPU size reports them, shares within [0, 100] and
the select walk's lane use within (0, 100]."""

from __future__ import annotations

import pytest

from bench_port import harness
from bench_port.run import Context, execute
from bench_port.tests import small

#: the metrics each kind's cell reads from the span store
SPAN_METRICS = {
    "selfplay": ["search.select_self_share", "search.select_wait_share",
                 "search.select_lane_use"],
    "train": ["train.update_share", "pipeline.batch_share"],
}
SECONDS = {"selfplay": 6.0, "train": 1.5}
CELLS = {"selfplay": "selfplay.dg128x9", "train": "train.dg128x9"}


@pytest.mark.parametrize("kind", ["selfplay", "train"])
def test_traced_run_reads_the_span_metrics(kind):
    _, cfg, tr = small.cell(kind)
    ctx = Context(seed=2**31 + 29, seconds=SECONDS[kind], trace=True,
                  config=cfg, traffic=tr, device="cpu")
    listed = harness.metrics_of(CELLS[kind], True)
    assert set(SPAN_METRICS[kind]) <= {m["name"] for m in listed}
    out = execute(ctx, listed)
    assert all(c.ok for c in out["checks"]), out["checks"]
    got = out["metrics"]
    for name in SPAN_METRICS[kind]:
        value = got[name]["value"]
        assert got[name]["unit"] == "%"
        if name == "search.select_lane_use":
            assert 0.0 < value <= 100.0, (name, value)
        else:
            assert 0.0 <= value <= 100.0, (name, value)


def test_span_metrics_find_nothing_to_read():
    for name in [n for names in SPAN_METRICS.values() for n in names]:
        assert harness.reader(name)({"trace": False, "window_s": 1.0}) \
            is None
