"""Spans and counters of the scan loop, and the timed stages of a process's
start.

A span or a counter records only while a ``torch.profiler`` records: a
span then enters ``torch.profiler.record_function``, so it lands in the
profiler's Chrome trace beside the card's kernels, on the same clock, and
it also keeps, per name, its count, its total host-clock seconds and its
self seconds (the total less the spans that nest in it).  With no profiler
recording, ``span`` returns one shared no-op object: no clock read, no
torch call, no allocation.  The gate is torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``; a span decides at its
entry and ends as it began.

``stage`` times a once-per-process start stage on the host clock whether
or not a profiler records; the first reading of a name is kept, and later
entries of that name are the no-op.

    with tracing.span("vgen.drain"):
        ...
    tracing.count("matches", n)
    tracing.snapshot()  # {"start": {...}, "spans": {...}, "counters": {...}}
"""

from __future__ import annotations

import time

import torch

_profiler = torch.autograd.profiler

# name -> [count, total seconds, self seconds]
_spans: dict = {}
_counters: dict = {}
# name -> seconds of the first reading
_start: dict = {}
# the open recording spans, innermost last
_stack: list = []


class _Noop:
    """What ``span`` and ``stage`` return when there is nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return False

    def __exit__(self, *exc):
        return False

    def begin(self):
        pass

    def end(self):
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.inner = 0.0
        _stack.append(self)
        self.t0 = time.perf_counter()
        return True

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if _stack and _stack[-1] is self:
            _stack.pop()
        if _stack:
            _stack[-1].inner += dt
        s = _spans.get(self.name)
        if s is None:
            s = _spans[self.name] = [0, 0.0, 0.0]
        s[0] += 1
        s[1] += dt
        s[2] += dt - self.inner
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records ``name`` while a profiler records
    (its ``with`` value is True), else the shared no-op (False)."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


class _Stage:
    __slots__ = ("name", "rf", "t0", "done")

    def __init__(self, name: str):
        self.name, self.rf, self.t0, self.done = name, None, None, False

    def begin(self) -> None:
        """Start the clock, once (no profiler span: for a stage that does
        not nest in the spans around it)."""
        if self.t0 is None and not self.done:
            self.t0 = time.perf_counter()

    def end(self) -> None:
        if self.t0 is not None:
            _start.setdefault(self.name, time.perf_counter() - self.t0)
            self.t0, self.done = None, True

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.begin()
        return True

    def __exit__(self, *exc):
        self.end()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False


def stage(name: str):
    """The start stage ``name``, timed on the host clock the first time it
    is entered in a process (and a profiler span then, if one records);
    the no-op once it has a reading."""
    if name in _start:
        return NOOP
    return _Stage(name)


def snapshot() -> dict:
    """{"start": {stage: seconds}, "spans": {name: {"count", "total_s",
    "self_s"}}, "counters": {name: n}}."""
    return {
        "start": dict(_start),
        "spans": {k: {"count": c, "total_s": t, "self_s": s}
                  for k, (c, t, s) in _spans.items()},
        "counters": dict(_counters),
    }


def reset() -> None:
    _spans.clear()
    _counters.clear()
    _start.clear()
    _stack.clear()
