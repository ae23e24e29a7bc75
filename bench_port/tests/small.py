"""The benchmark's cells cut to sizes a CPU test run holds: a 16 x 2
tower, a few boards, small batches.  The rest of each configuration and
traffic mix is the cell's own."""

from __future__ import annotations

from bench_port import harness

#: each kind's configuration and traffic mix
FILES = {"selfplay": ("dg128x9", "selfplay_b1024_r1600"),
         "train": ("dg128x9", "train_b2048_bank1024")}


def cell(kind: str):
    """``(kind, config, traffic)`` of ``kind`` at a CPU size."""
    cfg = harness.load_json("configs", FILES[kind][0])
    tr = harness.load_json("traffic", FILES[kind][1])
    if kind == "selfplay":
        cfg.update(num_channels=16, num_blocks=2, compute_dtype="float32")
        tr.update(boards=4, grow_sims=3)
        tr["check"].update(capture_after=[1, 2, 3], capture_rows=4,
                           sample_boards=4)
    elif kind == "train":
        cfg.update(num_channels=16, num_blocks=2)
        cfg["train"]["batch_size"] = 64
        tr.update(batch_size=64, bank_games=16)
        tr["check"].update(batch_rows=4)
    return kind, cfg, tr

