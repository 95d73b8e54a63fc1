"""Sandbox placement policy (kube-scheduler default semantics, paper §4).

"The placement policy favors nodes with the least utilized resources while
aiming to balance resource utilization across CPU and memory" — i.e. K8s
LeastAllocated scoring combined with the balanced-allocation tiebreak.

The scoring semantics live in core/policies.py; this module owns the data
structures that make placement fast at paper scale (5000 workers, 2500
creations/s):

  * ``Placer`` — single scoring domain over all nodes. By default it keeps a
    lazy max-heap index per request signature so one placement costs
    O(dirty·log n) instead of re-scoring (and re-sorting) every node.
    The index reproduces the brute-force scan bit-for-bit, including the
    lowest-worker-id tie-break (property-tested in tests/test_property.py).
  * ``PartitionedPlacer`` — Archipelago-style sharded placement: nodes are
    statically partitioned (``wid % n_shards``), each shard has its own
    index, and a deterministic round-robin cursor picks the shard to try
    first. Keeps per-placement work bounded by the shard size in the
    5000-worker regime.

The sharded control plane (core/control_plane.py, ``cp_shards > 1``)
composes with ``PartitionedPlacer`` by construction: the CP builds one with
``n_shards = cp_shards`` and CP shard *k* scores ``placer.shards[k]``
directly — the exact worker partition shard *k* health-checks — so a
placement never crosses shards on the hot path. When shard *k*'s partition
is full, the CP's capacity spill (``ControlPlane._place``) probes the other
``shards[j]`` itself, least-loaded-first with backoff (work stealing) —
*not* through the parent entry point. The parent ``place()`` round-robin
entry point remains for single-domain callers
(``placement_policy="partitioned"`` with an unsharded CP).

A function *split* across a CP shard-set (``cp_fn_split_enabled``) needs no
new placer machinery: each subshard's creations call ``_place`` with that
subshard's context, scoring ``shards[k]`` — its own worker partition — so a
split function's replicas spread over the partitions of every subshard in
its set, and each subshard's spill steals independently. The placer still
sees one opaque stream of (cpu, mem) requests per shard.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class NodeAllocation:
    cpu_capacity: int
    mem_capacity: int
    cpu_used: int = 0
    mem_used: int = 0
    schedulable: bool = True

    def fits(self, cpu: int, mem: int) -> bool:
        return (self.schedulable
                and self.cpu_used + cpu <= self.cpu_capacity
                and self.mem_used + mem <= self.mem_capacity)

    def score(self, cpu: int, mem: int) -> float:
        """Higher is better: least-allocated, balanced across CPU and mem."""
        cpu_frac = (self.cpu_used + cpu) / self.cpu_capacity
        mem_frac = (self.mem_used + mem) / self.mem_capacity
        least_allocated = 1.0 - (cpu_frac + mem_frac) / 2.0
        balance = 1.0 - abs(cpu_frac - mem_frac)
        return 0.75 * least_allocated + 0.25 * balance


class _ScoreIndex:
    """Lazy max-heap over nodes for ONE (cpu, mem) request signature.

    Heap entries are ``(-score, wid, version)``; an entry is live iff its
    version matches the owning placer's current version for that node, so a
    node is re-scored only after its allocation actually changed (it lands in
    ``pending`` and is re-pushed on the next placement). Because every request
    served by this index has identical (cpu, mem), a live entry that does not
    fit can be dropped outright: the node re-enters via ``pending`` the next
    time its allocation changes.

    Tie-break: heapq orders equal ``-score`` entries by ascending wid — the
    same winner as the brute-force lowest-id-first scan.
    """

    __slots__ = ("cpu", "mem", "_heap", "pending")

    def __init__(self, cpu: int, mem: int):
        self.cpu = cpu
        self.mem = mem
        self._heap: List[Tuple[float, int, int]] = []
        self.pending: set = set()

    def pop_best(self, placer: "Placer") -> Optional[int]:
        nodes, versions, score = placer.nodes, placer._versions, placer._score
        if self.pending:
            # sorted: set iteration is hash-order (insertion-history
            # dependent for ints); push order is invisible to the heap's
            # (score, wid, version) total order, but a deterministic sweep
            # keeps replay byte-identical if the scoring ever gains state
            for wid in sorted(self.pending):
                node = nodes.get(wid)
                if node is None or not node.schedulable:
                    continue
                heapq.heappush(self._heap,
                               (-score(node, self.cpu, self.mem), wid,
                                versions[wid]))
            self.pending.clear()
        heap = self._heap
        while heap:
            neg_s, wid, ver = heapq.heappop(heap)
            if versions.get(wid) != ver:
                continue                      # stale: allocation changed
            node = nodes[wid]
            if not node.fits(self.cpu, self.mem):
                continue                      # dead for this signature until
            return wid                        # the node changes again
        return None


class Placer:
    """Tracks per-node allocation; picks the best node for a new sandbox.

    ``policy`` selects the scoring function (core/policies.py): "balanced"
    (kube default, used by all benchmarks), "hermod_packing", "random".
    ``use_index=False`` forces the original brute-force scan (the reference
    implementation the index is property-tested against).
    """

    def __init__(self, policy: str = "balanced",
                 use_index: Optional[bool] = None):
        from repro_torch.core.policies import PLACEMENT_POLICIES
        self.nodes: Dict[int, NodeAllocation] = {}
        self.policy = policy
        self._score = PLACEMENT_POLICIES[policy]
        if use_index is None:
            # call-order-dependent scores (marked ``stateful`` on the policy
            # function) cannot be cached in the index
            use_index = not getattr(self._score, "stateful", False)
        self.use_index = use_index
        self._versions: Dict[int, int] = {}
        self._indexes: Dict[Tuple[int, int], _ScoreIndex] = {}

    # -- node membership ---------------------------------------------------
    def add_node(self, worker_id: int, cpu_capacity: int, mem_capacity: int) -> None:
        self.nodes[worker_id] = NodeAllocation(cpu_capacity, mem_capacity)
        self._touch(worker_id)

    def remove_node(self, worker_id: int) -> None:
        if self.nodes.pop(worker_id, None) is not None:
            # bump — never drop — the version: popping it would let heap
            # entries from this incarnation resurrect if the id re-registers
            self._versions[worker_id] += 1
        for idx in self._indexes.values():
            idx.pending.discard(worker_id)

    def set_schedulable(self, worker_id: int, ok: bool) -> None:
        if worker_id in self.nodes:
            self.nodes[worker_id].schedulable = ok
            self._touch(worker_id)

    def _touch(self, worker_id: int) -> None:
        """Invalidate cached scores after an allocation/schedulability change."""
        self._versions[worker_id] = self._versions.get(worker_id, 0) + 1
        for idx in self._indexes.values():
            idx.pending.add(worker_id)

    # -- placement ---------------------------------------------------------
    def place(self, cpu: int, mem: int) -> Optional[int]:
        if self.use_index:
            best_id = self._index_for(cpu, mem).pop_best(self)
        else:
            best_id = self._place_brute(cpu, mem)
        if best_id is not None:
            self.commit(best_id, cpu, mem)
        return best_id

    def _place_brute(self, cpu: int, mem: int) -> Optional[int]:
        best_id, best_score = None, float("-inf")
        for wid in sorted(self.nodes):
            node = self.nodes[wid]
            if not node.fits(cpu, mem):
                continue
            s = self._score(node, cpu, mem)
            if s > best_score:
                best_id, best_score = wid, s
        return best_id

    def _index_for(self, cpu: int, mem: int) -> _ScoreIndex:
        idx = self._indexes.get((cpu, mem))
        if idx is None:
            idx = _ScoreIndex(cpu, mem)
            idx.pending.update(self.nodes)
            self._indexes[(cpu, mem)] = idx
        return idx

    def commit(self, worker_id: int, cpu: int, mem: int) -> None:
        node = self.nodes[worker_id]
        node.cpu_used += cpu
        node.mem_used += mem
        self._touch(worker_id)

    def release(self, worker_id: int, cpu: int, mem: int) -> None:
        node = self.nodes.get(worker_id)
        if node is None:
            return
        node.cpu_used = max(0, node.cpu_used - cpu)
        node.mem_used = max(0, node.mem_used - mem)
        self._touch(worker_id)


class PartitionedPlacer(Placer):
    """Archipelago-style sharded placer for the multi-thousand-worker regime.

    Nodes are statically assigned to ``n_shards`` partitions (``wid %
    n_shards``), each with its own score index. A placement probes shards in
    deterministic round-robin order starting from a cursor that advances once
    per placement, falling through to the next shard when the preferred one
    has no fitting node — so per-placement work is bounded by one shard and
    load spreads evenly across partitions without any randomness.
    """

    def __init__(self, policy: str = "balanced", n_shards: int = 8,
                 use_index: Optional[bool] = None):
        if policy == "partitioned":
            policy = "balanced"      # scoring inside a shard is kube-default
        super().__init__(policy=policy, use_index=use_index)
        self.n_shards = max(1, n_shards)
        self.shards: List[Placer] = [
            Placer(policy=policy, use_index=self.use_index)
            for _ in range(self.n_shards)
        ]
        self._cursor = 0

    def _shard(self, worker_id: int) -> Placer:
        return self.shards[worker_id % self.n_shards]

    def add_node(self, worker_id: int, cpu_capacity: int, mem_capacity: int) -> None:
        shard = self._shard(worker_id)
        shard.add_node(worker_id, cpu_capacity, mem_capacity)
        # parent view shares the shard's NodeAllocation objects so existing
        # introspection (tests, recovery) keeps working unchanged
        self.nodes[worker_id] = shard.nodes[worker_id]

    def remove_node(self, worker_id: int) -> None:
        self._shard(worker_id).remove_node(worker_id)
        self.nodes.pop(worker_id, None)

    def set_schedulable(self, worker_id: int, ok: bool) -> None:
        self._shard(worker_id).set_schedulable(worker_id, ok)

    def place(self, cpu: int, mem: int) -> Optional[int]:
        start, self._cursor = self._cursor, self._cursor + 1
        for k in range(self.n_shards):
            shard = self.shards[(start + k) % self.n_shards]
            wid = shard.place(cpu, mem)
            if wid is not None:
                return wid
        return None

    def commit(self, worker_id: int, cpu: int, mem: int) -> None:
        self._shard(worker_id).commit(worker_id, cpu, mem)

    def release(self, worker_id: int, cpu: int, mem: int) -> None:
        self._shard(worker_id).release(worker_id, cpu, mem)


def make_placer(policy: str = "balanced", **kw) -> Placer:
    """Placer factory: ``policy="partitioned"`` selects the sharded placer;
    anything else is a scoring-policy name for the flat placer."""
    if policy == "partitioned":
        return PartitionedPlacer(policy="balanced", **kw)
    return Placer(policy=policy, **kw)
