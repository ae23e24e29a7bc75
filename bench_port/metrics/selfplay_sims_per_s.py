"""Positions the search evaluated (roots and leaves, every board of every
batched call) over the window's seconds (host clock); the window ends
inside the first move, and every board is within its rollout budget
there, so each evaluation is a charged simulation."""


def read(record):
    if "positions" not in record:
        return None
    return record["positions"] / record["window_s"]
