"""The program's spans and counters, recorded on the profiler's clock.

    from ..utils import spans

    @spans.spanned("search.select")
    def _select_flat(...):
        ...
        with spans.span("search.select.wait"):
            finished = bool(done.all())
    spans.count("search.simulations")
    spans.count_device("search.select.board_levels", tensor)

Spans record while a ``torch.profiler`` records, or inside
:func:`recording`; otherwise :func:`span` returns one shared no-op and
:func:`count` returns at once, after two reads (the profiler's own flag,
which its ``start()`` and ``stop()`` switch, and the count of open
``recording`` contexts): no allocation, no profiler call.  A recorded
span keeps its name, its start and end in nanoseconds of
``time.time_ns()`` (the clock of the profiler's events), its parent (the
innermost recorded span open on the same thread when it opened) and its
request id (given, or its parent's: the simulation number in the search,
the step number in the trainer).  While a profiler records, a span also
opens ``record_function(name)``, so it sits in the device trace beside
the kernels it launched.

A session begins when a span or counter finds recording on after it was
last seen off, and when :func:`recording` is entered; so in a run that
profiles part of its work, the last session is the profiled part.
:func:`snapshot` gives the last session: for each span name its calls,
total seconds and self seconds (its duration less its direct
children's), the counters, and up to ``EVENT_CAP`` raw spans (with a
count of those dropped).  A device counter adds its tensor on the
device, without a synchronisation, and is read at :func:`snapshot`.

A span closes on an exception.  Spans nest on one thread, so a span is
never left open across a ``yield``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time

import torch.autograd.profiler as _profiler

#: raw spans a session keeps; its aggregates are kept whatever the count
EVENT_CAP = 200_000


class _Session:
    """What one session recorded."""

    def __init__(self):
        self.start_ns = time.time_ns()
        self.end_ns = self.start_ns
        self.table = {}           # name -> [calls, total_ns, self_ns]
        self.counters = {}        # name -> int
        self.device = {}          # name -> accumulating tensor
        self.events = []          # (id, name, start, end, parent, request)
        self.dropped = 0
        self.ids = itertools.count()


class _Recorder:
    """The process's sessions, and each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.forced = 0           # open ``recording()`` contexts
        self.seen_on = False
        self.session = None

    def current(self) -> _Session:
        """The session a recording call belongs to, begun anew when
        recording was last seen off."""
        if not self.seen_on or self.session is None:
            with self.lock:
                self.session = _Session()
                self.seen_on = True
        return self.session

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "request", "session", "parent", "id", "start",
                 "child_ns", "rf")

    def __init__(self, name, request, session):
        self.name = name
        self.request = request
        self.session = session

    def __enter__(self):
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        if parent is not None and parent.session is not self.session:
            parent = None
        self.parent = parent
        if self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(self.session.ids)
        self.child_ns = 0
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        dur = end - self.start
        if self.parent is not None:
            self.parent.child_ns += dur
        s = self.session
        with _REC.lock:
            row = s.table.get(self.name)
            if row is None:
                row = s.table[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += dur
            row[2] += dur - self.child_ns
            s.end_ns = max(s.end_ns, end)
            if len(s.events) < EVENT_CAP:
                s.events.append((self.id, self.name, self.start, end,
                                 None if self.parent is None
                                 else self.parent.id, self.request))
            else:
                s.dropped += 1
        return False


def active() -> bool:
    """Whether spans and counters record now."""
    if _profiler._is_profiler_enabled or _REC.forced:
        return True
    _REC.seen_on = False
    return False


def span(name: str, request: int | None = None):
    """A context manager timing ``name`` while recording is on; a shared
    no-op otherwise."""
    if _profiler._is_profiler_enabled or _REC.forced:
        return _Span(name, request, _REC.current())
    _REC.seen_on = False
    return _NOOP


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``;
    a wrapper set on the function's module attribute (a profiling
    harness's) stays outside the span."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while recording is on."""
    if _profiler._is_profiler_enabled or _REC.forced:
        s = _REC.current()
        with _REC.lock:
            s.counters[name] = s.counters.get(name, 0) + int(n)
    else:
        _REC.seen_on = False


def count_device(name: str, tensor) -> None:
    """Add the device scalar ``tensor`` to the counter ``name`` while
    recording is on, on the device; read at :func:`snapshot`."""
    if _profiler._is_profiler_enabled or _REC.forced:
        s = _REC.current()
        with _REC.lock:
            acc = s.device.get(name)
            s.device[name] = tensor.detach().long() if acc is None \
                else acc + tensor.detach().long()
    else:
        _REC.seen_on = False


@contextlib.contextmanager
def recording():
    """Record spans and counters without a profiler; entering the
    outermost such context begins a session, and leaving it ends it."""
    with _REC.lock:
        _REC.forced += 1
        if _REC.forced == 1:
            _REC.session = _Session()
            _REC.seen_on = True
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1
            if not _REC.forced:
                _REC.seen_on = False


def snapshot() -> dict:
    """The last session: ``spans`` (name -> calls, total_s, self_s),
    ``counters`` (host and device, name -> int), ``events`` (raw spans:
    id, name, start_ns, end_ns, parent id, request), ``dropped``, and the
    session's ``start_ns`` and ``end_ns``.  Empty when nothing was
    recorded."""
    s = _REC.session
    if s is None:
        return {"spans": {}, "counters": {}, "events": [], "dropped": 0,
                "start_ns": None, "end_ns": None}
    with _REC.lock:
        table = {k: list(v) for k, v in s.table.items()}
        counters = dict(s.counters)
        device = dict(s.device)
        events = list(s.events)
        dropped = s.dropped
    for name, acc in device.items():
        counters[name] = counters.get(name, 0) + int(acc.item())
    return {
        "spans": {k: {"calls": c, "total_s": t / 1e9, "self_s": own / 1e9}
                  for k, (c, t, own) in table.items()},
        "counters": counters,
        "events": [{"id": i, "name": n, "start_ns": a, "end_ns": b,
                    "parent": p, "request": r}
                   for i, n, a, b, p, r in events],
        "dropped": dropped, "start_ns": s.start_ns, "end_ns": s.end_ns}


def export(path: str) -> None:
    """Write :func:`snapshot` to ``path`` as JSON."""
    with open(path, "w") as fh:
        json.dump(snapshot(), fh)
