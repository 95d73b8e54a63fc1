"""Concurrency-based autoscaling policy (Knative KPA defaults).

The paper (§4) states Dirigent implements and uses *Knative's default*
scheduling policies so the comparison is apples-to-apples; both our Dirigent
model and the Knative baseline share this exact implementation.

Algorithm (KPA): desired = ceil(avg_concurrency / target). Two sliding
windows — a 60 s *stable* window and a 6 s *panic* window. If the panic
desired count is >= 2x the current ready count, the autoscaler enters panic
mode and never scales down while panicking. Scale-to-zero happens only after
the stable window average is zero for the scale-to-zero grace period.

Mechanism → paper section map (claim ids C1..C12 as in costmodel.py):

  * ``ConcurrencyWindow`` — the KPA stable/panic averaging windows, fed by
    the DP metric pushes (§3.2: periodic every 250 ms + urgent on queue
    formation). Sampling is per-function, which is why metric ingestion
    needs no CP lock.
  * ``FunctionAutoscalerState.desired`` — §4 "Scheduling policies": the
    per-function decision the control plane's reconcile loop acts on every
    ``autoscale_period`` (2 s). Acting on the decision — not computing it —
    is what serializes on the CP scale lock (C1); under a skewed function
    mix that lock pressure is what the load-adaptive sharded CP rebalances
    (control_plane.py).
  * ``no_downscale_until`` — §3.4.1 post-recovery hold: a recovering leader
    must not scale down on a partial view (``recovery_no_downscale``, 60 s).
  * ``max_scale`` / panic no-downscale — Knative semantics kept exactly so
    the Dirigent model and the Knative baseline share one implementation
    (apples-to-apples, §5 methodology).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

import numpy as np

from repro_torch.core.abstractions import ScalingConfig


def split_shares(desired: int, k: int, cursor: int) -> List[int]:
    """Divide a desired replica count across ``k`` subshards of a split
    function (control_plane.py ``cp_fn_split_enabled``): everyone gets
    ``desired // k``, and the ``r = desired % k`` residual replicas land on
    the subshards at positions ``(cursor + i) % k``. The caller advances
    ``cursor`` by ``r`` after each assignment, so over successive autoscale
    decisions the residual rotates deterministically — no subshard
    permanently carries the remainder, and two runs with the same event
    sequence produce the same shares (the split path stays seed-exact)."""
    base, r = divmod(desired, k)
    return [base + (1 if (i - cursor) % k < r else 0) for i in range(k)]


@dataclass
class ConcurrencyWindow:
    """Time-bucketed average of a concurrency signal.

    Times and values live in parallel deques (not one deque of tuples) so
    ``average`` is a C-speed ``sum`` over plain floats — same addition order,
    bit-identical result, no per-sample generator frame. A cold burst parks
    thousands of samples in the window and re-averages on every urgent
    reconcile; this sum was one of the hottest loops in the churn benchmark."""

    horizon: float
    times: Deque[float] = field(default_factory=deque)
    values: Deque[float] = field(default_factory=deque)

    def record(self, t: float, value: float) -> None:
        self.times.append(t)
        self.values.append(value)
        self._evict(t)

    def _evict(self, t: float) -> None:
        times, values = self.times, self.values
        cut = t - self.horizon
        while times and times[0] < cut:
            times.popleft()
            values.popleft()

    def average(self, t: float) -> float:
        self._evict(t)
        if not self.values:
            return 0.0
        return sum(self.values) / len(self.values)

    def max(self, t: float) -> float:
        self._evict(t)
        if not self.values:
            return 0.0
        return max(self.values)


class VectorWindow:
    """Array-backed ``ConcurrencyWindow``: same sliding-window semantics on a
    numpy ring buffer.

    A cold burst at 20k+ workers parks tens of thousands of samples per
    function and re-averages on every urgent reconcile; the deque window pays
    a Python-level popleft per evicted sample plus a C ``sum`` per average.
    Here eviction is one ``np.searchsorted`` (sample times are monotone
    non-decreasing — the DES clock only moves forward) and the average is one
    ``ndarray.sum`` over a contiguous slice.

    NOT bit-identical to the deque reference: numpy uses pairwise summation,
    so the average can differ from sequential ``sum`` in the last float bits.
    The autoscaler only consumes the average through ``math.ceil(avg /
    target)``, which is insensitive to last-bit noise except exactly at
    integer boundaries, so this class is *decision-identical* in practice and
    is gated behind ``vectorized=True`` (default off; tests/test_vectorized.py
    asserts decision identity on randomized streams)."""

    __slots__ = ("horizon", "_t", "_v", "_lo", "_hi")

    _INIT_CAP = 64

    def __init__(self, horizon: float):
        self.horizon = horizon
        self._t = np.empty(self._INIT_CAP, dtype=np.float64)
        self._v = np.empty(self._INIT_CAP, dtype=np.float64)
        self._lo = 0
        self._hi = 0

    def _compact(self, need: int) -> None:
        n = self._hi - self._lo
        cap = self._t.shape[0]
        if n + need > cap:
            new_cap = max(cap * 2, n + need, self._INIT_CAP)
            nt = np.empty(new_cap, dtype=np.float64)
            nv = np.empty(new_cap, dtype=np.float64)
            nt[:n] = self._t[self._lo:self._hi]
            nv[:n] = self._v[self._lo:self._hi]
            self._t, self._v = nt, nv
        else:
            self._t[:n] = self._t[self._lo:self._hi]
            self._v[:n] = self._v[self._lo:self._hi]
        self._lo, self._hi = 0, n

    def record(self, t: float, value: float) -> None:
        if self._hi == self._t.shape[0]:
            self._compact(1)
        self._t[self._hi] = t
        self._v[self._hi] = value
        self._hi += 1
        self._evict(t)

    def _evict(self, t: float) -> None:
        cut = t - self.horizon
        # samples strictly older than the cut drop out, matching the deque
        # reference's ``times[0] < cut`` loop
        self._lo += int(np.searchsorted(self._t[self._lo:self._hi], cut,
                                        side="left"))

    def __len__(self) -> int:
        return self._hi - self._lo

    def average(self, t: float) -> float:
        self._evict(t)
        n = self._hi - self._lo
        if n == 0:
            return 0.0
        return float(self._v[self._lo:self._hi].sum()) / n

    def max(self, t: float) -> float:
        self._evict(t)
        if self._hi == self._lo:
            return 0.0
        return float(self._v[self._lo:self._hi].max())


class FunctionAutoscalerState:
    """Per-function autoscaler state machine."""

    def __init__(self, scaling: ScalingConfig, vectorized: bool = False):
        self.scaling = scaling
        win = VectorWindow if vectorized else ConcurrencyWindow
        self.stable = win(scaling.stable_window)
        self.panic = win(scaling.panic_window)
        self.in_panic_since: float | None = None
        self.max_panic_desired = 0
        self.zero_since: float | None = None
        self.no_downscale_until: float = 0.0  # recovery hold (paper §3.4.1)

    def record_metric(self, t: float, concurrency: float) -> None:
        self.stable.record(t, concurrency)
        self.panic.record(t, concurrency)

    def desired(self, t: float, ready: int) -> int:
        s = self.scaling
        stable_avg = self.stable.average(t)
        panic_avg = self.panic.average(t)
        desired_stable = math.ceil(stable_avg / s.target_concurrency)
        desired_panic = math.ceil(panic_avg / s.target_concurrency)

        # Panic entry: short-window demand at least 2x what we have ready.
        if desired_panic >= s.panic_threshold * max(ready, 1) and desired_panic > 0:
            self.in_panic_since = t
            self.max_panic_desired = max(self.max_panic_desired, desired_panic)
        # Panic exit after a full stable window without re-triggering.
        if self.in_panic_since is not None and t - self.in_panic_since > s.stable_window:
            self.in_panic_since = None
            self.max_panic_desired = 0

        if self.in_panic_since is not None:
            d = max(desired_panic, self.max_panic_desired, ready)
        else:
            d = desired_stable

        d = min(d, s.max_scale)

        # Scale-to-zero only after the grace period of zero load.
        if d == 0:
            if self.zero_since is None:
                self.zero_since = t
            if t - self.zero_since < s.scale_to_zero_grace:
                d = min(ready, 1) if ready > 0 else 0
        else:
            self.zero_since = None

        # Post-recovery hold: never downscale before no_downscale_until.
        if t < self.no_downscale_until:
            d = max(d, ready)
        return d
