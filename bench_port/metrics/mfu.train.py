"""Percent of the card's bf16 peak (989 TFLOP/s) that the trainer's steps
make over the traced window: three times the tower's forward operations a
position (forward, and the backward's two products) times the examples
trained, over the seconds to the last step's end."""

from bench_port.harness import PEAK_BF16_FLOPS


def read(record):
    if not record.get("trace") or not record.get("steps"):
        return None
    return (100.0 * 3 * record["flops_per_position"] * record["batch"]
            * record["steps"] / record["to_last_step_s"] / PEAK_BF16_FLOPS)
