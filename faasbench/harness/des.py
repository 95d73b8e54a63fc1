"""The orchestrator's set-up helpers the cells use.

Frozen copies of ``benchmarks/torch_common.py`` (``SWEEP_SCALING``,
``make_dirigent``, ``preload_functions``, its Cluster branch), as of the
benchmark's first version, so the yardstick does not move with later edits
there.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import Cluster, ScalingConfig
from repro_torch.core.abstractions import Function as Fn
from repro_torch.simcore import Environment

# copied from benchmarks/torch_common.py: the cold-start sweep's scaling
SWEEP_SCALING = dict(stable_window=1.0, panic_window=1.0,
                     scale_to_zero_grace=0.2, cpu_req_millis=100,
                     mem_req_mb=128)


def make_dirigent(env: Environment, n_workers: int = 93,
                  runtime: str = "firecracker", **kw) -> Cluster:
    """Copied from benchmarks/torch_common.py."""
    cl = Cluster(env, n_workers=n_workers, runtime=runtime, **kw)
    cl.start()
    return cl


def preload_functions(system: Cluster, names: List[str],
                      scaling_kw: Optional[dict] = None) -> None:
    """Install functions directly, bypassing registration (copied from
    benchmarks/torch_common.py, its Cluster branch without persistence)."""
    scaling_kw = scaling_kw or {}
    leader = system.control_plane_leader()
    for name in names:
        fn = Fn(name=name, image_url="img://bench", port=80,
                scaling=ScalingConfig(**scaling_kw))
        leader.install_function(fn)
        for dp in system.data_planes:
            dp.sync_functions([name])
