"""Percent of the profiled part of the window in which no kernel, copy or
set ran on the device (the union of the trace's device intervals)."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
