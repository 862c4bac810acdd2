"""Spans of the solver's phases on the host, stamped on the profiler's clock.

A span is one named interval of the host's time: a family of batched
solves, one trip of its loop, a phase of the trip, an evaluation hook, a
KKT factorization or solve, a host read of device values. Spans nest: each
holds the id of the span that was open when it began (its parent) and the
id of the family span above it (its request), and a few integer
attributes (lanes, counts).

:data:`recorder` is on exactly when ``hiop_tpu_torch.linalg.kernels.stats``
has ``timing`` set (:attr:`KernelStats.timing` reads and writes
:attr:`Recorder.on`). Off, a span site costs one attribute test and hands
back the shared :data:`NOOP`: no clock read, no allocation, no device call.

Stamps are ``time.time_ns()``: the clock of ``torch.profiler``'s events
(``_KinetoEvent.start_ns``), so that every device operation and idle gap in
a profiler trace of the same run falls inside the innermost span that was
open when it was launched. :meth:`Recorder.export_chrome` writes the spans
as a Chrome trace that loads beside the profiler's own.

A run's operator::

    from hiop_tpu_torch.linalg import kernels
    from hiop_tpu_torch.utils import trace

    kernels.stats.timing = True       # spans on (and the kernels' CUDA events)
    ...                               # solve
    kernels.stats.timing = False
    trace.recorder.export_chrome("spans.json")
"""

from __future__ import annotations

import json
import os
import time

#: the most spans the recorder keeps; later ones are counted in ``dropped``
CAPACITY = 1 << 20


class _Noop:
    """The span site's stand-in while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value) -> None:
        pass


NOOP = _Noop()


class Span:
    """One recorded interval; its own context manager (closing it stamps
    ``end`` and leaves the recorder's stack)."""

    __slots__ = ("name", "start", "end", "id", "parent", "family", "attrs", "_rec")

    def __init__(self, rec, name, sid, parent, family):
        self.name = name
        self.id = sid
        self.parent = parent
        self.family = family
        self.attrs = {}
        self.end = None
        self._rec = rec
        self.start = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        self._rec._stack.pop()
        return False

    def set(self, key, value) -> None:
        self.attrs[key] = value

    @property
    def duration(self) -> int:
        """Nanoseconds (0 while open)."""
        return 0 if self.end is None else self.end - self.start


class Recorder:
    """The spans of this process, at most :data:`CAPACITY`."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.on = False
        self.capacity = capacity
        self.spans: list = []
        self.dropped = 0
        self._stack: list = []
        self._next = 0

    def span(self, name: str, request: bool = False):
        """A context manager around one phase; ``request``: the span is a
        family's root, the ``family`` of everything under it."""
        if not self.on:
            return NOOP
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return NOOP
        top = self._stack[-1] if self._stack else None
        sid = self._next
        self._next += 1
        if request:
            family = sid
        else:
            family = None if top is None else top.family
        s = Span(self, name, sid, None if top is None else top.id, family)
        self._stack.append(s)
        self.spans.append(s)
        return s

    def clear(self) -> None:
        """Forget every closed span (open ones stay on the stack)."""
        self.spans = []
        self.dropped = 0

    def export_chrome(self, path, beside=None) -> int:
        """Write the closed spans as a Chrome trace (``"ph": "X"`` events,
        microseconds) to ``path``; returns the number of events. ``beside``:
        the path of a trace written by ``torch.profiler``'s
        ``export_chrome_trace`` in this run, whose time base
        (``baseTimeNanoseconds``) the spans then take, so that the two files
        load on one timeline."""
        base = 0
        if beside is not None:
            with open(beside) as f:
                base = int(json.load(f).get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        events = []
        for s in self.spans:
            if s.end is None:
                continue
            args = dict(s.attrs, id=s.id, parent=s.parent, family=s.family)
            events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                           "tid": 0, "ts": (s.start - base) / 1e3,
                           "dur": (s.end - s.start) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base}, f)
        return len(events)


def self_ns(span, kids) -> int:
    """``span``'s duration less the union of its children's intervals
    (``kids``: the closed spans whose parent it is)."""
    cover, reach = 0, span.start
    for k in sorted(kids, key=lambda k: k.start):
        lo, hi = max(k.start, reach), min(k.end, span.end)
        if hi > lo:
            cover += hi - lo
            reach = hi
    return span.duration - cover


#: the process's recorder (switched by ``kernels.stats.timing``)
recorder = Recorder()
