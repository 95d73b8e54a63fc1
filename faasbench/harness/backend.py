"""Spans and counters taken around the calls into the program's layers.

Everything here wraps the program from outside: a ``LiveBackend`` subclass
whose hooks are timed as they call the program's own, and a wrapper around
each batcher's ``step``. No span goes inside the program.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

from repro_torch.live import LiveBackend


class Spans:
    """Wall seconds by span name, summed while ``on``. With
    ``profiling`` each span is also a ``torch.profiler.record_function``
    range, so the trace can say what the host did in a device gap."""

    def __init__(self):
        self.on = False
        self.profiling = False
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if self.on:
                    self.seconds[name] += time.perf_counter() - t0


class StepLog:
    """One row per batcher step while ``on``: the host clock at its end, its
    wall seconds, the slots active, the tokens it produced, the positions
    each active slot attends over; and (while ``lens_on``) every slot's
    length as the step is given it. ``before`` is called before each
    logged step (the window's clock: a pump runs many steps inside one DES
    event)."""

    def __init__(self):
        self.on = False
        self.lens_on = False
        self.before = None
        self.rows: List[tuple] = []
        self.lens: List[list] = []


class BenchBackend(LiveBackend):
    """The program's ``LiveBackend``, its hooks timed, each batcher's steps
    logged, and which sandbox took which request kept. ``after_create`` is
    called after each creation and ``before_first_collect`` before the
    first collect (the window's opening)."""

    def __init__(self, spec, spans: Spans, steps: StepLog, device=None):
        super().__init__(default_spec=spec, device=device)
        self.spans = spans
        self.steps = steps
        self.sandbox_of: Dict[int, int] = {}
        self.creations_in_window = 0
        self.after_create = self.before_first_collect = None

    def create_hook(self, sandbox) -> None:
        with self.spans("backend.create"):
            super().create_hook(sandbox)
        self.creations_in_window += self.spans.on
        self._wrap(self.sandboxes[sandbox.sandbox_id].batcher)
        if self.after_create is not None:
            self.after_create()

    def _wrap(self, batcher) -> None:
        """Time ``batcher.step`` and log what each step carried."""
        step, spans, log = batcher.step, self.spans, self.steps

        def timed_step():
            if not log.on:
                return step()
            if log.before is not None:
                log.before()
            active = [s for s in batcher.slots if s.active]
            made = sum(1 for s in active if len(s.pending) <= 1)
            if log.lens_on:
                log.lens.append([s.length for s in batcher.slots])
            t0 = time.perf_counter()
            with spans("batcher.step"):
                out = step()
            t1 = time.perf_counter()
            log.rows.append((t1, t1 - t0, len(active), made,
                             [s.length + 1 for s in active]))
            return out

        batcher.step = timed_step

    def admit(self, sandbox_id, req):
        with self.spans("backend.admit"):
            ticket = super().admit(sandbox_id, req)
        self.sandbox_of[id(req)] = sandbox_id
        return ticket

    def collect(self, ticket):
        first, self.before_first_collect = self.before_first_collect, None
        if first is not None:
            first()
        with self.spans("backend.collect"):
            return super().collect(ticket)

    def teardown_hook(self, sandbox_id: int, drain: bool = True) -> None:
        with self.spans("backend.teardown"):
            super().teardown_hook(sandbox_id, drain)


HOOK_SPANS = ("backend.create", "backend.admit", "backend.collect",
              "backend.teardown")
