"""Percent of the profiled part of the window that the trainer's host
spent in its parameter updates: the seconds of the program's spans
``train.update`` (the decoupled L2, Adam's step and the max-norm
projection of the conv kernels) and ``train.ema``."""

from bench_port.program_spans import share


def read(record):
    return share(record, ["train.update", "train.ema"])
