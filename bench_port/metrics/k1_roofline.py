"""Percent of its roofline that the leaf kernel K1 reaches in the profiled
part of the window: the least time its launches there could take (their
bytes, ``counts.leaf_step_bytes``, over the HBM rate) over their device
time in the trace."""

from bench_port.harness import PEAK_HBM_BYTES
from bench_port.profiling import kernel_seconds


def read(record):
    prof = record.get("profile")
    if not prof or not record.get("k1_bytes"):
        return None
    seconds, _ = kernel_seconds(prof, "leaf_step_kernel")
    if seconds <= 0:
        return None
    return 100.0 * record["k1_bytes"] / PEAK_HBM_BYTES / seconds
