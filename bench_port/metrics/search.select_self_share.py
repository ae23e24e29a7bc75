"""Percent of the profiled part of the window that the search's select
walk spent on the host outside its waits for the device: the self seconds
of the program's span ``search.select`` (its time less that of its
``search.select.wait`` children), without synchronisation."""

from bench_port.program_spans import share


def read(record):
    return share(record, ["search.select"], "self_s")
