"""The traced run's readings: stage timers synchronised at both ends, and a
``torch.profiler`` window summarised in memory.

The stage timer is the method of the program's ``trace.py``
(``_timed``): a call is timed between two ``torch.cuda.synchronize()``
calls, and a call made inside another call of the same stage is not
counted twice.  Synchronising slows the run, so timers are set only in
``--trace 1`` runs, whose per-layer metrics are shares and counts.

The profiler window's device time is the union of the kernel, copy and
set intervals of its trace (what ``trace.py::_device_time`` sums by
kernel), so overlapping streams are not counted twice; idle gaps are the
stretches of the window with no device activity, named by the innermost
host span open where each begins.
"""

from __future__ import annotations

import bisect
import collections
import functools
import time

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimers:
    """Seconds and calls by stage name, and host spans for the
    profiler."""

    def __init__(self):
        self.table = collections.defaultdict(lambda: [0.0, 0])

    def wrap(self, name: str, fn):
        active = [0]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if active[0]:
                return fn(*args, **kwargs)
            active[0] += 1
            sync()
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    out = fn(*args, **kwargs)
                sync()
            finally:
                active[0] -= 1
            self.table[name][0] += time.perf_counter() - t0
            self.table[name][1] += 1
            return out

        return wrapper

    def seconds(self, name: str) -> float:
        return self.table[name][0] if name in self.table else 0.0


class Patches:
    """Module attributes replaced for one run, restored on exit."""

    def __init__(self):
        self.saved = []

    def set(self, mod, attr, value):
        self.saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for mod, attr, value in reversed(self.saved):
            setattr(mod, attr, value)
        self.saved.clear()


def annotated(name: str, fn):
    """``fn`` inside a profiler span named ``name`` (no synchronisation)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm_up() -> None:
    """Start and stop a profiler once: its first start initialises the
    tracing libraries, which takes seconds, and belongs to set-up."""
    from torch.profiler import profile

    with profile(activities=_activities()):
        x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu")
        (x + x).sum().item()


class Window:
    """A profiler over part of a measured window: ``start()`` and
    ``stop()`` from the runner, ``summary()`` after."""

    def __init__(self):
        from torch.profiler import profile

        self.prof = profile(activities=_activities())
        self.t0 = self.t1 = None

    def start(self):
        sync()
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        if self.t0 is None or self.t1 is not None:
            return
        sync()
        self.t1 = time.time_ns()
        self.prof.stop()

    def summary(self) -> dict | None:
        if self.t0 is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.t0, self.t1)


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, t0: int, t1: int) -> dict:
    """Device busy seconds (the union of device activity inside [t0, t1],
    in the profiler's clock of nanoseconds since the epoch), device time
    and launches by kernel name, the ten device operations that took most
    time, and the ten longest idle gaps by the host span open at their
    start."""
    device, notes = [], []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if kind in DEVICE_ACTIVITIES or (not kind
                                             and not e.is_user_annotation()):
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.is_user_annotation():
            notes.append((e.start_ns(), e.end_ns(), e.name()))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for a, b, name in device:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            spans.append((a, b))
            by_name[name][0] += (b - a) / 1e9
            by_name[name][1] += 1
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    notes.sort()
    starts = [n[0] for n in notes]

    def label(t):
        best = None
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            a, b, name = notes[i]
            if a <= t < b:
                best = name
                break
            if t - a > 60e9:
                break
        return best or "host outside the timed stages"

    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_s,
        "kernels": {k: list(v) for k, v in by_name.items()},
        "device_ops": [[k[:120], v[0]] for k, v in top_ops],
        "idle_gaps": [[label(a), (b - a) / 1e9] for a, b in gaps[:10]],
    }


def kernel_seconds(summary: dict, fragment: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``fragment``."""
    total, count = 0.0, 0
    for name, (sec, n) in summary["kernels"].items():
        if fragment in name:
            total += sec
            count += n
    return total, count
