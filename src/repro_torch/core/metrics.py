"""Experiment metric collection: per-invocation records, percentiles, CDFs."""
from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.request import Invocation


def percentile(xs: Iterable[float], p: float) -> float:
    arr = np.asarray(list(xs), dtype=np.float64)
    if arr.size == 0:
        return float("nan")
    return float(np.percentile(arr, p))


def geomean(xs: Iterable[float]) -> float:
    arr = np.asarray(list(xs), dtype=np.float64)
    arr = arr[arr > 0]
    if arr.size == 0:
        return float("nan")
    return float(np.exp(np.mean(np.log(arr))))


@dataclass
class Collector:
    invocations: List[Invocation] = field(default_factory=list)
    events: List[tuple] = field(default_factory=list)   # (t, kind, detail)
    sandbox_creations: int = 0
    sandbox_teardowns: int = 0
    reconciles: int = 0        # autoscale/reconcile decisions taken by the CP
    fn_migrations: int = 0     # functions moved between CP shards (rebalancer)
    fn_splits: int = 0         # functions split across a CP shard-set
    fn_merges: int = 0         # split functions folded back to a sole owner
    steal_probes: int = 0      # cross-shard capacity probes paid (spill path)
    steals: int = 0            # placements satisfied by a foreign shard

    # per-kind timestamp index (events arrive in nondecreasing sim time, so
    # each list is sorted): the failover benches probe creation timelines
    # per cell, and at 100k-worker scale each probe was a full O(events)
    # scan of the flat list
    _times_by_kind: Dict[str, List[float]] = field(default_factory=dict)

    def done(self, inv: Invocation) -> None:
        self.invocations.append(inv)

    def event(self, t: float, kind: str, detail: object = None) -> None:
        self.events.append((t, kind, detail))
        self._times_by_kind.setdefault(kind, []).append(t)

    # -- views ---------------------------------------------------------------
    @property
    def completed(self) -> List[Invocation]:
        return [i for i in self.invocations if not i.failed]

    @property
    def failed(self) -> List[Invocation]:
        return [i for i in self.invocations if i.failed]

    def sched_latencies(self, warmup: float = 0.0) -> np.ndarray:
        return np.array([i.scheduling_latency for i in self.completed
                         if i.arrival >= warmup], dtype=np.float64)

    def slowdowns(self, warmup: float = 0.0) -> np.ndarray:
        return np.array([i.slowdown for i in self.completed
                         if i.arrival >= warmup], dtype=np.float64)

    def e2e_latencies(self, warmup: float = 0.0) -> np.ndarray:
        return np.array([i.e2e_latency for i in self.completed
                         if i.arrival >= warmup], dtype=np.float64)

    def event_times(self, kind: str, after: float = 0.0) -> List[float]:
        """Timestamps of every recorded ``kind`` event at or after ``after``
        (failover analysis: creation timelines, recovery milestones)."""
        ts = self._times_by_kind.get(kind, [])
        return ts[bisect_left(ts, after):]

    def first_event_at(self, kind: str, after: float = 0.0) -> Optional[float]:
        """Instant of the first ``kind`` event at or after ``after``; ``None``
        if it never happened. ``first_event_at("sandbox-created", t_kill)``
        is the failover benchmark's time-to-first-creation probe."""
        ts = self._times_by_kind.get(kind, [])
        i = bisect_left(ts, after)
        return ts[i] if i < len(ts) else None

    def window_sched_latencies(self, t0: float, t1: float) -> np.ndarray:
        """Scheduling latencies of completed invocations that *arrived*
        inside ``[t0, t1)`` — the recovery-window view: requests landing
        between leader kill and full recovery, wherever they finish."""
        return np.array([i.scheduling_latency for i in self.completed
                         if t0 <= i.arrival < t1], dtype=np.float64)

    def per_function_mean_sched(self, warmup: float = 0.0) -> Dict[str, float]:
        acc: Dict[str, List[float]] = defaultdict(list)
        for i in self.completed:
            if i.arrival >= warmup:
                acc[i.function_name].append(i.scheduling_latency)
        return {f: float(np.mean(v)) for f, v in acc.items()}

    def per_function_geomean_slowdown(self, warmup: float = 0.0) -> Dict[str, float]:
        acc: Dict[str, List[float]] = defaultdict(list)
        for i in self.completed:
            if i.arrival >= warmup:
                acc[i.function_name].append(i.slowdown)
        return {f: geomean(v) for f, v in acc.items()}

    def summary(self, warmup: float = 0.0) -> Dict[str, float]:
        sched = self.sched_latencies(warmup)
        slow = self.slowdowns(warmup)
        pf_sched = list(self.per_function_mean_sched(warmup).values())
        pf_slow = list(self.per_function_geomean_slowdown(warmup).values())
        return {
            "n_completed": len(self.completed),
            "n_failed": len(self.failed),
            "sched_p50_ms": percentile(sched, 50) * 1e3,
            "sched_p99_ms": percentile(sched, 99) * 1e3,
            "slowdown_p50": percentile(slow, 50),
            "slowdown_p99": percentile(slow, 99),
            "perfn_sched_p50_ms": percentile(pf_sched, 50) * 1e3,
            "perfn_sched_p99_ms": percentile(pf_sched, 99) * 1e3,
            "perfn_slowdown_p50": percentile(pf_slow, 50),
            "perfn_slowdown_p99": percentile(pf_slow, 99),
            "sandbox_creations": self.sandbox_creations,
        }
