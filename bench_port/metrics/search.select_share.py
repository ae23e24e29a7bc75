"""Percent of the traced window's wall time inside the search's select
walk (``mcts.search._select_flat``), each call timed between two device
synchronisations."""


def read(record):
    if record.get("select_s") is None:
        return None
    return 100.0 * record["select_s"] / record["window_s"]
