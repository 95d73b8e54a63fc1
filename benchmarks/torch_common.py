"""Shared benchmark harness utilities."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import Cluster, Function, ScalingConfig
from repro_torch.core.abstractions import Function as Fn
from repro_torch.core.autoscaler import FunctionAutoscalerState
from repro_torch.core.baseline_knative import KnativeCluster, KnFunctionState
from repro_torch.core.control_plane import FunctionState
from repro_torch.simcore import Environment


# Scaling config for cold-start sweep microbenchmarks: hello-world functions
# with aggressive teardown so the 93-node cluster sustains thousands of
# creations/s (the paper's Fig 7 regime).
SWEEP_SCALING = dict(stable_window=1.0, panic_window=1.0,
                     scale_to_zero_grace=0.2, cpu_req_millis=100,
                     mem_req_mb=128)


def make_dirigent(env: Environment, n_workers: int = 93,
                  runtime: str = "firecracker", **kw) -> Cluster:
    cl = Cluster(env, n_workers=n_workers, runtime=runtime, **kw)
    cl.start()
    return cl


def make_knative(env: Environment, n_workers: int = 93, **kw) -> KnativeCluster:
    return KnativeCluster(env, n_workers=n_workers, **kw)


def preload_functions(system, names: List[str],
                      scaling_kw: Optional[dict] = None,
                      persist: bool = False) -> None:
    """Install functions directly (bypassing registration cost) for
    microbenchmarks where registration is not the measured quantity.

    ``persist=True`` additionally writes the ``function/<name>`` records to
    the durable store (draining the write log before returning) — required
    by failover benchmarks: ``recover_as_leader`` rebuilds the registry from
    those records, so functions preloaded without them would silently vanish
    on the first leader kill."""
    scaling_kw = scaling_kw or {}
    if isinstance(system, Cluster):
        leader = system.control_plane_leader()
        fns = []
        for name in names:
            fn = Fn(name=name, image_url="img://bench", port=80,
                    scaling=ScalingConfig(**scaling_kw))
            # install_function routes the record to its owning CP shard too
            leader.install_function(fn)
            fns.append(fn)
            for dp in system.data_planes:
                dp.sync_functions([name])
        if persist:
            env = system.env
            done = env.event()

            def persist_all(env):
                for fn in fns:
                    yield from system.store.write(f"function/{fn.name}",
                                                  fn.persisted_record())
                done.succeed(None)

            env.process(persist_all(env), name="preload-persist")
            env.run_until_event(done)
    else:
        for name in names:
            fn = Fn(name=name, image_url="img://bench", port=80,
                    scaling=ScalingConfig(**scaling_kw))
            system.functions[name] = KnFunctionState(
                function=fn, autoscaler=FunctionAutoscalerState(fn.scaling))


def run_open_loop(env: Environment, system, plan: List[tuple],
                  until_extra: float = 120.0,
                  request_factory: Optional[Callable] = None) -> List:
    """Submit (t, fn, exec_time) invocations open-loop; returns Invocations.

    Plan times are offsets from *traffic start* (``env.now`` at call time),
    and so is the run horizon: boot work already on the clock — at 20k
    workers the O(n_workers)-fsyncs registration alone is ~30 s of sim time
    — must not eat the measurement window, or large-worker cells silently
    truncate mid-submission.

    ``request_factory(i)`` (live mode) builds the ``LiveRequest`` riding
    invocation ``i``; every dispatch then executes real payload work."""
    invs = []

    def driver(env):
        t_prev = 0.0
        for i, (t, fn, et) in enumerate(plan):
            if t > t_prev:
                yield env.timeout(t - t_prev)
                t_prev = t
            if request_factory is not None:
                invs.append(system.invoke(fn, exec_time=et,
                                          request=request_factory(i)))
            else:
                invs.append(system.invoke(fn, exec_time=et))

    env.process(driver(env), name="bench-driver")
    horizon = env.now + (plan[-1][0] if plan else 0.0) + until_extra
    env.run(until=horizon)
    return invs


def latency_stats(invs, field: str = "scheduling_latency") -> Dict[str, float]:
    vals = np.array([getattr(i, field) for i in invs
                     if i.t_done > 0 and not i.failed], dtype=np.float64)
    done = int(vals.size)
    total = len(invs)
    if done == 0:
        return {"done": 0, "total": total, "p50": float("nan"),
                "p99": float("nan"), "mean": float("nan")}
    return {
        "done": done, "total": total,
        "p50": float(np.percentile(vals, 50)),
        "p99": float(np.percentile(vals, 99)),
        "mean": float(vals.mean()),
    }


class CsvReporter:
    """Accumulates ``name,us_per_call,derived`` rows (benchmarks/run.py)."""

    def __init__(self):
        self.rows: List[tuple] = []

    def add(self, name: str, us_per_call: float, derived: str = "") -> None:
        self.rows.append((name, us_per_call, derived))
        print(f"{name},{us_per_call:.3f},{derived}", flush=True)

    def header(self) -> None:
        print("name,us_per_call,derived", flush=True)
