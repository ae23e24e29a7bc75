"""Percent of the profiled part of the window that the example pipeline's
host spent making batches: the seconds of the program's span
``pipeline.batch`` (a batch's rows gathered from the bank and
augmented)."""

from bench_port.program_spans import share


def read(record):
    return share(record, ["pipeline.batch"])
