"""Discrete-event simulation engine (simpy-lite).

A minimal, deterministic, generator-based DES used to run the Dirigent and
Knative/K8s cluster-manager models in virtual time. Design goals:

  * determinism — a single event heap ordered by (time, seq); all randomness
    flows through named ``RngStream``s so runs are exactly reproducible;
  * generator processes — components are written as ``def proc(env): yield
    env.timeout(x)`` coroutines, like simpy;
  * tiny surface — Timeout, Event, Store (FIFO queue), Resource (counting
    semaphore), process interrupt/kill; nothing else is needed;
  * a cheap hot path — the engine itself must not be the bottleneck when a
    5000-worker cluster model is simulated (benchmarks/churn_scale.py tracks
    ``events_per_wall_s``). Hot-path events schedule *bound methods*, never
    per-event lambda closures; ``Process``/``Timeout``/``AnyOf`` carry
    ``__slots__``; and a process that is the sole waiter of a Timeout is
    resumed directly from the timer callback without touching the generic
    callback list (``Timeout._waiter``).

Besides events, the engine offers two zero-event modeling devices used by
the demand-driven timers in core/:

  * ``Environment.schedule_at`` — run a plain callback at an absolute sim
    time (one heap entry, no Process/Timeout objects), and
  * ``Resource.reserve`` — a *lazy hold*: take a slot for a known interval
    without any heap traffic unless a contender actually shows up, in which
    case the release materializes as a real event at the exact instant the
    modeled holder would have released (FIFO semantics preserved).

The same component code can also run in "live" mode (see core/cluster.py):
live mode never yields timeouts for modeled service times, it executes real
work instead.
"""
from __future__ import annotations

import heapq
import itertools
import math
import os
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Generator, Optional

import numpy as np


class Interrupt(Exception):
    """Raised inside a process when another process interrupts it."""

    def __init__(self, cause: Any = None):
        super().__init__(cause)
        self.cause = cause


class Event:
    """One-shot event; processes wait on it by yielding it.

    Lifecycle: *triggered* means the firing has been scheduled; *fired* means
    callbacks have run (waiters registered after firing are called at once).
    """

    __slots__ = ("env", "_value", "_ok", "triggered", "fired", "callbacks")

    def __init__(self, env: "Environment"):
        self.env = env
        self._value: Any = None
        self._ok: bool = True
        self.triggered = False
        self.fired = False
        self.callbacks: list[Callable[["Event"], None]] = []

    @property
    def ok(self) -> bool:
        """False iff the event has failed. With ``any_of`` the loser's
        exception arrives as the *value*; check the winner's ``ok`` before
        trusting it."""
        return self._ok

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self._value = value
        self._ok = True
        self.env._schedule(self.env.now, self._run_callbacks)
        return self

    def fail(self, exc: BaseException) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self._value = exc
        self._ok = False
        self.env._schedule(self.env.now, self._run_callbacks)
        return self

    def add_callback(self, cb: Callable[["Event"], None]) -> None:
        """Register a waiter; if the event already fired, call it next turn."""
        if self.fired:
            self.env._schedule(self.env.now, lambda: cb(self))
        else:
            self.callbacks.append(cb)

    def _run_callbacks(self) -> None:
        self.fired = True
        cbs, self.callbacks = self.callbacks, []
        if not self._ok and not cbs:
            # Unobserved process failure: surface it instead of swallowing.
            raise self._value
        for cb in cbs:
            cb(self)


class Timeout(Event):
    """Fires after ``delay``. The overwhelmingly common waiter is a single
    Process (``yield env.timeout(x)``): that case is fast-pathed through the
    ``_waiter`` slot — the timer callback resumes the process directly,
    skipping callback-list append/swap/iterate entirely."""

    __slots__ = ("_waiter",)

    def __init__(self, env: "Environment", delay: float, value: Any = None,
                 at: Optional[float] = None):
        """Relative by default; pass ``at`` (absolute sim time) to fire at an
        exact precomputed instant — ``env.now + (t - env.now)`` does not
        round-trip in floating point, so timers that must hit a deadline
        bit-exactly (the heartbeat wheel) cannot go through a delay."""
        super().__init__(env)
        if at is None:
            if delay < 0:
                raise ValueError(f"negative delay {delay}")
            at = env.now + delay
        elif at < env.now:
            raise ValueError(f"timeout into the past: {at} < {env.now}")
        self._value = value
        self._waiter: Optional["Process"] = None
        env._schedule(at, self._trigger_now)

    def _trigger_now(self) -> None:
        self.triggered = True
        w = self._waiter
        if w is not None:
            self._waiter = None
            if not self.callbacks:
                # sole-waiter fast path: resume the process in-line
                self.fired = True
                if w._target is self:       # not interrupted/killed meanwhile
                    w._target = None
                    w._resume(self._value, True)
                return
            # callbacks were added after the sole waiter registered (rare):
            # fall back to the generic path, waiter first (registration order)
            self.callbacks.insert(0, w._on_target)
        self._run_callbacks()


class Process(Event):
    """A running generator. Also an Event that triggers when it returns."""

    __slots__ = ("gen", "name", "_target", "_alive")

    def __init__(self, env: "Environment", gen: Generator, name: str = "?"):
        super().__init__(env)
        self.gen = gen
        self.name = name
        self._target: Optional[Event] = None
        self._alive = True
        env._schedule(env.now, self._start)

    @property
    def is_alive(self) -> bool:
        return self._alive

    def _start(self) -> None:
        self._resume(None, True)

    def _detach_target(self) -> None:
        """Stop waiting on the current target (interrupt/kill)."""
        target, self._target = self._target, None
        if target is not None and not target.triggered:
            if type(target) is Timeout and target._waiter is self:
                target._waiter = None
            else:
                try:
                    target.callbacks.remove(self._on_target)
                except ValueError:
                    pass

    def interrupt(self, cause: Any = None) -> None:
        """Interrupt the process (throws Interrupt at its current yield)."""
        if not self._alive:
            return
        # Detach from whatever it is waiting on, then resume with an error.
        self._detach_target()
        self.env._schedule(self.env.now, lambda: self._throw(Interrupt(cause)))

    def kill(self) -> None:
        """Terminate the process without running any more of its body."""
        if not self._alive:
            return
        self._alive = False
        self._detach_target()
        san = self.env.sanitizer
        if san is None:
            self.gen.close()
        else:
            # GeneratorExit unwinds finally blocks that may release locks:
            # they must be attributed to this process
            san.current = self
            try:
                self.gen.close()
            finally:
                san.current = None
                san.on_process_end(self)
        if not self.triggered:
            self.succeed(None)

    # -- internal ---------------------------------------------------------
    def _on_target(self, evt: Event) -> None:
        if self._target is not evt:
            return  # stale wake-up (we were interrupted/killed meanwhile)
        self._target = None
        self._resume(evt._value, evt._ok)

    def _throw(self, exc: BaseException) -> None:
        if not self._alive:
            return
        san = self.env.sanitizer
        if san is not None:
            san.current = self
        try:
            nxt = self.gen.throw(exc)
        except StopIteration as stop:
            self._finish(stop.value)
            return
        except Interrupt:
            # Process chose not to catch the interrupt: dies quietly.
            self._finish(None)
            return
        except BaseException as e:  # noqa: BLE001 — simpy semantics
            self._fail(e)
            return
        finally:
            if san is not None:
                san.current = None
        self._wait_on(nxt)

    def _resume(self, value: Any, ok: bool) -> None:
        if not self._alive:
            return
        san = self.env.sanitizer
        if san is None:
            # hot path, untouched when sanitize is off
            try:
                nxt = self.gen.send(value) if ok else self.gen.throw(value)
            except StopIteration as stop:
                self._finish(stop.value)
                return
            except BaseException as e:  # noqa: BLE001 — simpy semantics
                self._fail(e)
                return
            self._wait_on(nxt)
            return
        san.current = self
        try:
            nxt = self.gen.send(value) if ok else self.gen.throw(value)
        except StopIteration as stop:
            self._finish(stop.value)
            return
        except BaseException as e:  # noqa: BLE001 — simpy semantics
            self._fail(e)
            return
        finally:
            san.current = None
        self._wait_on(nxt)

    def _wait_on(self, evt: Any) -> None:
        if type(evt) is Timeout:
            # sole-waiter fast path: a fresh `yield env.timeout(x)` — by far
            # the hottest wait in any simulation — skips the callback list
            if evt._waiter is None and not evt.fired and not evt.callbacks:
                self._target = evt
                evt._waiter = self
                return
        elif not isinstance(evt, Event):
            raise TypeError(f"process {self.name} yielded non-event {evt!r}")
        self._target = evt
        evt.add_callback(self._on_target)

    def _finish(self, value: Any) -> None:
        self._alive = False
        san = self.env.sanitizer
        if san is not None:
            san.on_process_end(self)
        if not self.triggered:
            self.succeed(value)

    def _fail(self, exc: BaseException) -> None:
        """Process raised: fail our event. A waiting parent gets the exception
        thrown at its yield; an unobserved failure crashes the event loop."""
        self._alive = False
        san = self.env.sanitizer
        if san is not None:
            san.on_process_end(self)
        if not self.triggered:
            self.fail(exc)


def _observed(evt: "Event") -> None:
    """Shared no-op observer left on a detached any_of loser: failures of a
    raced-and-lost event stay *observed* (not re-raised into the event loop),
    exactly as when the dead AnyOf closure was still attached."""


class AnyOf(Event):
    """Triggers when the first of ``events`` triggers; value = (index, value).

    When the winner fires, the callbacks registered on the still-pending
    *losers* are detached. Without that, a long-lived event that repeatedly
    loses ``any_of`` races (e.g. a completion event raced against retry
    timeouts in a loop) accumulates one dead closure per race for the rest of
    its life — a genuine memory/CPU leak in long simulations. A loser left
    with no other waiter gets the shared ``_observed`` sentinel (at most one,
    ever), keeping the pre-detach failure semantics without the per-race
    closure."""

    __slots__ = ("_done", "_waits")

    def __init__(self, env: "Environment", events: list[Event]):
        super().__init__(env)
        self._done = False
        self._waits: list[tuple[Event, Callable[[Event], None]]] = []
        for i, e in enumerate(events):
            cb = self._make_cb(i)
            self._waits.append((e, cb))
            e.add_callback(cb)

    def _make_cb(self, i: int) -> Callable[[Event], None]:
        def cb(evt: Event) -> None:
            self._fire(i, evt._value)
        return cb

    def _fire(self, i: int, value: Any) -> None:
        if self._done or self.triggered:
            return
        self._done = True
        # detach loser callbacks: an event that never fires must not keep a
        # reference to this (finished) AnyOf via its callback list. Losers
        # already triggered will fire on their own; their callback finds
        # ``_done`` set and is a no-op.
        for e, cb in self._waits:
            if not e.triggered and not e.fired:
                try:
                    e.callbacks.remove(cb)
                except ValueError:
                    pass
                if not e.callbacks:
                    e.callbacks.append(_observed)
        self._waits = []
        self.succeed((i, value))


class Store:
    """Unbounded FIFO queue with blocking get()."""

    def __init__(self, env: "Environment", name: Optional[str] = None):
        self.env = env
        self.name = name
        self.items: Deque[Any] = deque()
        self._getters: Deque[Event] = deque()

    def put(self, item: Any) -> None:
        san = self.env.sanitizer
        if san is not None:
            san.on_store(self)
        if self._getters:
            evt = self._getters.popleft()
            evt.succeed(item)
        else:
            self.items.append(item)

    def get(self) -> Event:
        san = self.env.sanitizer
        if san is not None:
            san.on_store(self)
        evt = Event(self.env)
        if self.items:
            evt.succeed(self.items.popleft())
        else:
            self._getters.append(evt)
        return evt

    def __len__(self) -> int:
        return len(self.items)


class Resource:
    """Counting semaphore; models a contended resource (CPU, lock, ports).

    ``reserve(until)`` is a *lazy hold*: it takes a slot synchronously for a
    known interval without scheduling anything. If nobody contends before
    ``until``, the hold is reclaimed in-place by the next acquire/reserve —
    zero heap events for the whole critical section. The first contender
    *materializes* the release as a real scheduled event at exactly
    ``until``, so queueing (who waits, until when, in what order) is
    indistinguishable from a process that acquired, held a timeout and
    released. This is what lets the C9 heartbeat lock touches cost no events
    unless they actually collide with a creation (core/control_plane.py)."""

    __slots__ = ("env", "capacity", "in_use", "name", "_waiters",
                 "_reserved_until")

    def __init__(self, env: "Environment", capacity: int = 1,
                 name: Optional[str] = None):
        self.env = env
        self.capacity = capacity
        self.in_use = 0
        self.name = name
        self._waiters: Deque[Event] = deque()
        self._reserved_until: Optional[float] = None

    def _settle_reservation(self) -> None:
        """Resolve an outstanding lazy hold: reclaim it if it expired, or
        materialize its release event if it is still running (a contender is
        about to queue behind it)."""
        r = self._reserved_until
        if r is None:
            return
        self._reserved_until = None
        if self.env.now >= r:
            self.in_use -= 1        # the phantom holder released in the past
        else:
            self.env._schedule(r, self.release)

    def reserve(self, until: float) -> bool:
        """Lazily hold one slot until sim time ``until`` (see class doc).
        Returns False when the resource is busy or waited on — the caller
        must then fall back to the normal acquire/timeout/release path."""
        if self._reserved_until is not None:
            if self.env.now >= self._reserved_until:
                self.in_use -= 1
                self._reserved_until = None
            else:
                return False        # an earlier lazy hold is still running
        if self.in_use < self.capacity and not self._waiters:
            san = self.env.sanitizer
            if san is not None:
                san.on_reserve(self)
            self.in_use += 1
            self._reserved_until = until
            return True
        return False

    def acquire(self) -> Event:
        self._settle_reservation()
        san = self.env.sanitizer
        if san is not None:
            san.on_acquire(self)
        evt = Event(self.env)
        if self.in_use < self.capacity:
            self.in_use += 1
            evt.succeed(None)
        else:
            self._waiters.append(evt)
        return evt

    def release(self) -> None:
        san = self.env.sanitizer
        if san is not None:
            san.on_release(self)
        if self._waiters:
            evt = self._waiters.popleft()
            evt.succeed(None)
        else:
            self.in_use -= 1
            if self.in_use < 0:
                raise RuntimeError("release without acquire")

    @property
    def queue_len(self) -> int:
        return len(self._waiters)


@dataclass
class RngStream:
    """Named deterministic random stream."""

    rng: np.random.Generator

    def expovariate(self, rate: float) -> float:
        return float(self.rng.exponential(1.0 / rate))

    def lognormal(self, median: float, sigma: float) -> float:
        return float(median * np.exp(self.rng.normal(0.0, sigma)))

    def uniform(self, lo: float, hi: float) -> float:
        return float(self.rng.uniform(lo, hi))

    def randint(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi))

    def choice(self, n: int) -> int:
        return int(self.rng.integers(0, n))

    def random(self) -> float:
        return float(self.rng.random())


def stable_hash(name: str) -> int:
    """Process-independent string hash (builtin ``hash`` is salted per
    process and must never feed simulation state)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def grid_ceil(x: float, quantum: float) -> float:
    """Smallest multiple of ``quantum`` that is ``>= x``.

    Deadline quantization for cohort scheduling (the heartbeat wheel's
    ``hb_cohort_quantum``): timers rounded UP onto one shared grid collapse
    into cohorts that pop in a single heap event. With a power-of-two
    quantum (e.g. ``0.0078125 == 2**-7``) both the division and the final
    multiply are exact float operations, so grid points accumulated as
    ``t + k*period`` (period itself a multiple of the quantum) stay ON the
    grid bit-exactly — cohorts never drift apart."""
    return math.ceil(x / quantum) * quantum


class Environment:
    """The event loop. Time is float seconds.

    ``sanitize=True`` (or env var ``REPRO_SANITIZE=1``) attaches a runtime
    determinism sanitizer — lock-order cycle detection, same-instant tie
    auditing, global-RNG discipline (see simcore/sanitize.py). The
    sanitizer observes through hooks that are dead branches when off and
    schedules no events when on, so event counts are bit-identical either
    way."""

    def __init__(self, seed: int = 0, sanitize: Optional[bool] = None):
        self.now: float = 0.0
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._next_seq = itertools.count().__next__
        self._seed = seed
        self._streams: dict[str, RngStream] = {}
        self.events_processed = 0   # wall-clock throughput accounting
        if sanitize is None:
            sanitize = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")
        if sanitize:
            from .sanitize import Sanitizer
            self.sanitizer: Optional["Sanitizer"] = Sanitizer(self)
        else:
            self.sanitizer = None

    # -- rng ---------------------------------------------------------------
    def rng(self, name: str) -> RngStream:
        if name not in self._streams:
            # independent child stream per name, derived from the seed via a
            # stable hash — builtin hash() is salted per process
            # (PYTHONHASHSEED), which silently broke cross-process
            # reproducibility of every benchmark
            ss = np.random.SeedSequence(self._seed)
            child = np.random.SeedSequence(
                entropy=ss.entropy, spawn_key=(stable_hash(name),))
            self._streams[name] = RngStream(np.random.default_rng(child))
        return self._streams[name]

    # -- primitives ---------------------------------------------------------
    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def timeout_at(self, t: float, value: Any = None) -> Timeout:
        """A timeout firing at *absolute* sim time ``t`` (bit-exact)."""
        return Timeout(self, 0.0, value, at=t)

    def event(self) -> Event:
        return Event(self)

    def any_of(self, events: list[Event]) -> AnyOf:
        return AnyOf(self, events)

    def store(self, name: Optional[str] = None) -> Store:
        return Store(self, name)

    def resource(self, capacity: int = 1,
                 name: Optional[str] = None) -> Resource:
        return Resource(self, capacity, name)

    def process(self, gen: Generator, name: str = "?") -> Process:
        return Process(self, gen, name)

    # -- loop ---------------------------------------------------------------
    def _schedule(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, self._next_seq(), fn))

    def schedule_at(self, t: float, fn: Callable[[], None]) -> None:
        """Run a plain callback at absolute sim time ``t`` (>= now).

        The cheapest way to model a timer: one heap entry, no Process or
        Timeout objects. Used by demand-driven background machinery (netcfg
        refills, lazy lock releases) whose per-firing work is plain state
        mutation, not a coroutine."""
        if t < self.now:
            raise ValueError(f"schedule_at into the past: {t} < {self.now}")
        heapq.heappush(self._heap, (t, self._next_seq(), fn))

    def run(self, until: Optional[float] = None) -> None:
        san = self.sanitizer
        if san is not None:
            san.begin_run()
        # localized loop: heap/pop bound once; the count is folded back in a
        # finally so events_processed stays correct when a callback raises
        heap = self._heap
        pop = heapq.heappop
        n = 0
        try:
            while heap:
                if until is not None and heap[0][0] > until:
                    self.now = until
                    if san is not None:
                        san.end_run()
                    return
                item = pop(heap)
                self.now = item[0]
                n += 1
                item[2]()
            if until is not None:
                self.now = until
        finally:
            self.events_processed += n
        if san is not None:
            san.end_run()

    def run_until_event(self, evt: Event, hard_limit: float = 1e12) -> Any:
        san = self.sanitizer
        if san is not None:
            san.begin_run()
        heap = self._heap
        pop = heapq.heappop
        n = 0
        try:
            while not evt.fired:
                if not heap:
                    break
                item = pop(heap)
                if item[0] > hard_limit:
                    raise RuntimeError("run_until_event exceeded hard limit")
                self.now = item[0]
                n += 1
                item[2]()
        finally:
            self.events_processed += n
        if san is not None:
            san.end_run()
        if not evt.fired:
            raise RuntimeError("event never triggered")
        return evt._value
