"""The 95th percentile of every step's milliseconds in the window, from
one batch request to the next (host clock)."""

from bench_port.harness import percentile


def read(record):
    steps = record.get("step_s")
    if not steps:
        return None
    return percentile(steps, 95) * 1e3
