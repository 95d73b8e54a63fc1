"""Pluggable scheduling policies (paper §4).

"Dirigent supports Hermod [56] and CH-RLU [50] scheduling policies, though
they are unused in our evaluation to ensure a fair comparison to Knative.
Implementing new scheduling policies and metrics involves extending the
relevant Go interfaces" — this module is that interface surface, in Python:

  * load balancing (data plane): ``least_loaded`` (Knative default, used by
    every benchmark), ``ch_rlu`` (consistent hashing with bounded loads and
    warm-locality preference, after Fuerst & Sharma HPDC'22), ``random``;
  * placement (control plane): ``balanced`` (kube-scheduler default, used by
    every benchmark), ``hermod_packing`` (Hermod's hybrid: pack onto the
    busiest node that still fits, keeping other nodes free for bursts),
    ``random``; plus ``partitioned`` (Archipelago-style sharded placement for
    the 5000-worker regime — a placer structure, not a scoring function; see
    core/placement.py).

Three sharding knobs exist and they are different layers:

  * ``placement_policy="partitioned"`` shards only the placer's *score
    index* (a data-structure optimization inside one scheduling domain);
  * ``Cluster(cp_shards=N)`` shards the *control plane itself* — per-shard
    scale locks, autoscale loops, health monitors and endpoint-flush queues
    (core/control_plane.py). With ``cp_shards > 1`` the CP composes a
    ``PartitionedPlacer`` whose partitions align with the CP shards, so any
    scoring policy here runs shard-locally on the hot path; when a shard's
    partition is full, the spill steals capacity from the least-loaded
    foreign shard (with backoff) rather than probing round-robin, and
    ``Cluster(cp_rebalance_enabled=True)`` additionally migrates hot
    functions off overloaded shards (docs/operations.md);
  * ``Cluster(cp_fn_split_enabled=True)`` shards *individual hot functions*:
    when one function's creation load dominates a shard (no whole-function
    move fixes that), its ownership escalates from one shard to a shard-set
    — per-subshard state slices, each creating under its own scale lock on
    its own placer partition — and folds back when the heat decays
    (core/control_plane.py ``FunctionSlice``; docs/operations.md).

Benchmarks keep the Knative-default policies for paper fidelity; the
policies here are selectable via ``Cluster(lb_policy=...)`` /
``Placer(policy=...)`` / ``Cluster(cp_shards=...)`` and covered by
tests/test_policies.py and tests/test_cp_sharding.py.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional


# -- load balancing (endpoint selection in the data plane) --------------------

def lb_least_loaded(endpoints: Dict[int, object], fn: str,
                    exclude: Optional[int] = None) -> Optional[object]:
    # direct attribute reads, not the Endpoint.free property: this scan runs
    # once per dispatch over every endpoint of the function and dominated
    # burst-drain wall time; selection (first-seen wins ties, same iteration
    # order) is unchanged
    best = None
    best_in_use = -1
    for sid, ep in endpoints.items():
        if sid == exclude or ep.draining:
            continue
        in_use = ep.in_use
        if in_use < ep.capacity and (best is None or in_use < best_in_use):
            best = ep
            best_in_use = in_use
    return best


def lb_random(endpoints: Dict[int, object], fn: str,
              exclude: Optional[int] = None, _state={"n": 0}) -> Optional[object]:
    free = [ep for sid, ep in endpoints.items()
            if sid != exclude and ep.free > 0]
    if not free:
        return None
    _state["n"] += 1
    return free[_state["n"] % len(free)]


def lb_ch_rlu(endpoints: Dict[int, object], fn: str,
              exclude: Optional[int] = None,
              load_bound: float = 2.0) -> Optional[object]:
    """Consistent hashing with Relaxed Load Upper-bounds (CH-RLU, simplified):
    prefer the ring position hashed from the function name (warm locality —
    the same sandbox keeps serving the function), walking forward when the
    preferred sandbox exceeds the load bound."""
    sids = sorted(sid for sid in endpoints if sid != exclude)
    if not sids:
        return None
    h = int(hashlib.md5(fn.encode()).hexdigest(), 16)
    start = h % len(sids)
    mean_load = max(sum(endpoints[s].in_use for s in sids) / len(sids), 0.25)
    # first pass: bounded-load walk from the preferred position
    for k in range(len(sids)):
        ep = endpoints[sids[(start + k) % len(sids)]]
        if ep.free > 0 and ep.in_use <= load_bound * mean_load:
            return ep
    # relaxed pass: any free slot
    for k in range(len(sids)):
        ep = endpoints[sids[(start + k) % len(sids)]]
        if ep.free > 0:
            return ep
    return None


LB_POLICIES = {
    "least_loaded": lb_least_loaded,
    "ch_rlu": lb_ch_rlu,
    "random": lb_random,
}


# -- placement (worker-node scoring in the control plane) -----------------------

def place_balanced(node, cpu: int, mem: int) -> float:
    """K8s default: least-allocated, balanced across CPU and memory."""
    cpu_frac = (node.cpu_used + cpu) / node.cpu_capacity
    mem_frac = (node.mem_used + mem) / node.mem_capacity
    least_allocated = 1.0 - (cpu_frac + mem_frac) / 2.0
    balance = 1.0 - abs(cpu_frac - mem_frac)
    return 0.75 * least_allocated + 0.25 * balance


def place_hermod(node, cpu: int, mem: int) -> float:
    """Hermod-style hybrid packing: prefer the MOST-utilized node that still
    fits (bin packing keeps whole nodes free, which helps cold-start bursts
    and lets idle nodes power down)."""
    cpu_frac = (node.cpu_used + cpu) / node.cpu_capacity
    mem_frac = (node.mem_used + mem) / node.mem_capacity
    return (cpu_frac + mem_frac) / 2.0


def place_random(node, cpu: int, mem: int, _state={"n": 0}) -> float:
    _state["n"] = (_state["n"] * 1103515245 + 12345) % (1 << 31)
    return _state["n"] / float(1 << 31)


# call-order-dependent scoring cannot be cached in the placer's incremental
# index (core/placement.py falls back to the brute-force scan)
place_random.stateful = True


PLACEMENT_POLICIES = {
    "balanced": place_balanced,
    "hermod_packing": place_hermod,
    "random": place_random,
}
