"""Percent of the lockstep select walk's board-levels that advanced a
board, over the profiled part of the window: the program's counters
``search.select.board_levels`` (boards that advanced, summed over every
level of every walk, counted on the device) over
``search.select.lane_trips`` (the walk's levels, the root's included,
times the boards)."""

from bench_port.program_spans import snapshot


def read(record):
    snap = snapshot(record)
    if snap is None:
        return None
    counters = snap["counters"]
    trips = counters.get("search.select.lane_trips", 0)
    if trips <= 0:
        return None
    return 100.0 * counters.get("search.select.board_levels", 0) / trips
