"""Whole runs of each cell at a CPU size, past the look for a card: a sound
run is correct, a run with a fault planted in the timed path is not, and
the lower-precision control reads above the program."""

from __future__ import annotations

import pytest

from bench_port import control, faults
from bench_port.tests import small

#: windows long enough for a few simulations or steps on a loaded CPU
SECONDS = {"selfplay": 6.0, "train": 1.5}
CASES = ([("selfplay", None), ("train", None)]
         + [("selfplay", f) for f in faults.SELFPLAY]
         + [("train", f) for f in faults.TRAIN])


@pytest.mark.parametrize("kind,fault", CASES,
                         ids=[f"{k}-{f or 'sound'}" for k, f in CASES])
def test_fault_makes_the_run_incorrect(kind, fault):
    name, cfg, tr = small.cell(kind)
    out = control.readings(name, 2**31 + 17, SECONDS[kind], fault, "cpu",
                           cfg, tr)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("kind", ["selfplay", "train"])
def test_control_reads_above_the_program(kind):
    name, cfg, tr = small.cell(kind)
    out = control.readings(name, 2**31 + 23, SECONDS[kind], None, "cpu",
                           cfg, tr)
    compared = out["checks"]
    assert any(v > compared[k] for k, v in out["control"].items()
               if k in compared), out


@pytest.mark.cuda
def test_control_at_the_cells_size(cuda_device):
    """On the card: the selfplay cell at its own size, the program correct
    and the control outside the limits."""
    out = control.readings("selfplay.dg128x9", 2**31 + 29, 5.0)
    assert out["correct"], out
    limits = small.harness.load_json(
        "traffic", "selfplay_b1024_r1600")["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()
               if k in limits), out
