"""The statistics the end-to-end metrics are taken with: a rate over the
whole window, a tail over every step."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import harness


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys(q):
    xs = np.random.default_rng(3).exponential(1.0, 101)
    assert harness.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_p95_is_over_every_step_not_chunk_medians():
    # 19 quick steps and one stall in each chunk of 20: every chunk's median
    # is quick, the tail of all steps is the stalls
    steps = ([0.07] * 19 + [0.5]) * 30
    read = harness.reader("train_step_p95_ms")
    p95 = read({"step_s": steps})
    medians = [np.median(steps[i:i + 20]) for i in range(0, 600, 20)]
    assert p95 == pytest.approx(1e3 * np.percentile(steps, 95))
    assert p95 > 1e3 * max(medians)


def test_rate_is_over_the_whole_window():
    # a slow first step counts: the rate is the work over all the time
    record = {"batch": 2048, "steps": 10, "to_last_step_s": 1.6,
              "step_s": [0.7] + [0.1] * 9}
    rate = harness.reader("train_examples_per_s")(record)
    assert rate == pytest.approx(2048 * 10 / 1.6)
    sims = harness.reader("selfplay_sims_per_s")(
        {"positions": 4096 * 101, "window_s": 10.0})
    assert sims == pytest.approx(4096 * 101 / 10.0)


def test_readers_find_nothing_to_read():
    for name in ("k1_roofline", "device_idle.selfplay", "mfu.train",
                 "search.select_share"):
        assert harness.reader(name)({"trace": False, "window_s": 1.0}) \
            is None
