"""Spans inside the program: where the live backend, the batcher, a decode
executable and its warm-up spend their time.

A span is a name, a start and an end on ``time.perf_counter()`` (the
clock a caller's own window is read on), its parent (the innermost span
open on the same thread when it began) and a few attributes. Ended spans
go to one log per process, in memory, that keeps the newest ``CAP`` spans.
``spans()`` returns the log and ``clear()`` empties it.

Two kinds of site:

  * ``step(name)``, on the path every decode step takes, records only
    while a ``torch.profiler`` session records. Otherwise the site costs
    one read of the profiler's own flag and returns a shared empty
    context: no clock read, no allocation, no CUDA event. ``step(name,
    timed=True)`` also records a pair of CUDA timing events around its
    work; their elapsed milliseconds become the span's ``device_ms`` when
    a later span ends after the device has passed the second event (the
    batcher's read of the step's result waits for it), so the timing adds
    no synchronisation of its own.
  * ``Span(name)``, on the creation path (a few per sandbox), records
    always.

While a profiler records, each span is also a
``torch.profiler.record_function`` range, so the profiler's trace places
it beside the device's work. Every name starts with ``backend.`` or
``batcher.``: a reader of that trace tells a program range's annotation on
the device's timeline from device work by those prefixes.
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from time import perf_counter
from typing import Deque, List, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16                       # spans the log keeps
PREFIXES = ("backend.", "batcher.")

_OFF = contextlib.nullcontext()     # a step-path site while nothing records
_lock = threading.Lock()
_log: Deque["Span"] = deque(maxlen=CAP)
_pending: List["Span"] = []         # timed spans whose events are not read
_open = threading.local()           # each thread's stack of open spans


class Span:
    """One timed stretch of the program, recorded whenever it is entered
    (``step`` builds one only while a profiler records); ``attrs`` may be
    filled while it is open."""

    __slots__ = ("name", "start", "end", "parent", "attrs", "_range",
                 "_events")

    def __init__(self, name: str, timed: bool = False):
        self.name = name
        self.start = self.end = 0.0
        self.parent: Optional[Span] = None
        self.attrs: dict = {}
        self._range = None
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) \
            if timed else None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = perf_counter()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        self.end = perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.stack.pop()
        _add(self)
        return False


def step(name: str, timed: bool = False):
    """A span on the step path: recorded only while a profiler records
    (else the shared empty context, which enters as None)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, timed)


def _add(s: Span) -> None:
    with _lock:
        _log.append(s)
        if s._events is not None:
            _pending.append(s)
        if _pending:
            _settle()


def _settle() -> None:
    """Each timed span whose second event the device has passed gets its
    ``device_ms`` (an event query waits for nothing)."""
    keep = []
    for s in _pending:
        if s._events[1].query():
            s.attrs["device_ms"] = s._events[0].elapsed_time(s._events[1])
            s._events = None
        else:
            keep.append(s)
    _pending[:] = keep


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    with _lock:
        if _pending:
            _settle()
        return list(_log)


def clear() -> None:
    with _lock:
        _log.clear()
        _pending.clear()
