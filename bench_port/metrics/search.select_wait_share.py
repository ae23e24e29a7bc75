"""Percent of the profiled part of the window that the search's select
walk spent waiting for the device at the end of each trip of its loop
(``bool(done.all())``): the seconds of the program's span
``search.select.wait``."""

from bench_port.program_spans import share


def read(record):
    return share(record, ["search.select.wait"])
