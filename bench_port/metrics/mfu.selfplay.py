"""Percent of the card's bf16 peak (989 TFLOP/s) that the search's tower
evaluations make over the traced window: the tower's operations a
position (``counts.tower_flops``) times the positions evaluated, over the
window's seconds."""

from bench_port.harness import PEAK_BF16_FLOPS


def read(record):
    if not record.get("trace") or "positions" not in record:
        return None
    return (100.0 * record["flops_per_position"] * record["positions"]
            / record["window_s"] / PEAK_BF16_FLOPS)
