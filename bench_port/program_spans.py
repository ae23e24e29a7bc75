"""The program's own span store (``dream_go_torch.utils.spans``), read
after a traced run.

The program records its spans and counters while a profiler records, so
the store's last session is the profiled part of the window, the same
stretch whose length is ``record["profile"]["window_s"]``.  A program
without the store (an older checkout) gives nothing to read, and so does
a run without a profile.
"""

from __future__ import annotations


def snapshot(record: dict) -> dict | None:
    """The store's last session, or None where there is nothing to read:
    no profile in ``record``, no span store in the program, or no span
    recorded."""
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    try:
        from dream_go_torch.utils import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    return snap if snap["spans"] else None


def share(record: dict, names, key: str = "total_s") -> float | None:
    """Percent of the profiled window spent in the spans ``names`` (their
    ``key`` seconds), or None where there is nothing to read or none of
    them was recorded."""
    snap = snapshot(record)
    if snap is None or not any(n in snap["spans"] for n in names):
        return None
    seconds = sum(snap["spans"][n][key] for n in names if n in snap["spans"])
    return 100.0 * seconds / record["profile"]["window_s"]
