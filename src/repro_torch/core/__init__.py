"""Dirigent core: the paper's contribution as a composable library.

Public surface:
    Cluster            — wire up a full Dirigent deployment (sim or live)
    Function           — user-facing registration record
    ScalingConfig      — per-function autoscaling knobs
    InvocationMode     — sync / async
    CostModel          — calibrated service-time constants
    KnativeCluster     — the K8s/Knative baseline (core.baseline_knative)
"""
from repro_torch.core.abstractions import (
    DataPlaneInfo,
    Function,
    FunctionMetrics,
    Sandbox,
    SandboxState,
    ScalingConfig,
    WorkerNodeInfo,
)
from repro_torch.core.cluster import Cluster
from repro_torch.core.costmodel import CostModel, DEFAULT_COSTS, DirigentCosts, KnativeCosts
from repro_torch.core.metrics import Collector, geomean, percentile
from repro_torch.core.request import Invocation, InvocationMode

__all__ = [
    "Cluster",
    "Collector",
    "CostModel",
    "DEFAULT_COSTS",
    "DataPlaneInfo",
    "DirigentCosts",
    "Function",
    "FunctionMetrics",
    "Invocation",
    "InvocationMode",
    "KnativeCosts",
    "Sandbox",
    "SandboxState",
    "ScalingConfig",
    "WorkerNodeInfo",
    "geomean",
    "percentile",
]
