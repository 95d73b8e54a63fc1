"""Sharded monolithic control plane (paper §3, §5.2.2).

One process-level component containing the state manager, autoscaler, placer
and health monitor as modules that exchange information via in-memory
channels (modeled at ``channel_op`` cost, vs RPC+etcd round-trips in K8s).

Persistence policy (paper Table 3): ``Function``/``DataPlane``/``WorkerNode``
records are written to the replicated store *at registration time*;
``Sandbox`` state and function scheduling metrics are in-memory only and are
reconstructed after failover (from worker nodes / DP traffic). The ablation
flag ``persist_sandbox_state`` puts a durable write back on the cold-start
critical path — reproducing the paper's "Dirigent optimization breakdown".

Sharding (``cp_shards``). The paper identifies Dirigent's own ceiling at
~2500 sandbox creations/s as "access congestion on shared data structures
used for autoscaling" (C1), with heartbeat processing degrading creation
throughput further at 5000 workers (C9). PR 1 sharded the *placer*; this
module shards the control plane itself. The CP is partitioned into
``cp_shards`` internal shards (``ControlPlaneShard``), and each shard owns:

  * its own scale lock (the per-shard slice of the autoscaling structures),
  * its own autoscale loop over the functions it owns,
  * its own health monitor over the workers it owns, and
  * its own CP→DP endpoint-update flush queue.

Functions route to shards through an **indirection table**
(``fn_shard_table``): every installed function gets an entry, seeded with
``simcore.stable_hash(name) % cp_shards``, and the load-adaptive rebalancer
(below) may later repoint it. Workers map to the shard
``worker_id % cp_shards`` — the same partition the ``PartitionedPlacer``
uses, so a shard's sandbox creation scores only its own workers and a
placement never crosses shards on the hot path. Cross-shard concerns take
explicit fan-out paths, each paying ``cp_cross_shard_op`` per foreign shard
touched instead of one global critical section:

  * capacity spill — a shard whose own workers are full *steals* capacity
    from foreign placer shards, probing them least-loaded-first by the same
    per-shard load signal the rebalancer uses; shards that recently failed a
    probe are back-offed to the end of the order, so a saturated cluster
    degrades to the deterministic round-robin probe sequence;
  * worker eviction — the owning shard detects the missed heartbeats, then
    fans the affected functions' reconciles out to their owning shards;
  * function migration — the rebalancer's handoff (quiesce both shards →
    move function state + pending endpoint-flush entries → repoint the
    indirection table → persist the override off the critical path);
  * leader recovery — ``recover_as_leader`` rebuilds every shard's function
    and worker maps from the persisted records in one pass, **including the
    indirection table**: persisted ``shardmap/`` overrides are re-applied so
    a failover does not silently undo the rebalancer's work.

Load-adaptive rebalancing (``cp_rebalance_enabled``, default off). A static
``stable_hash % N`` partition convoys on one shard when function popularity
is skewed (an Azure-style Zipf mix — exactly the regime the paper's 2500
creations/s claim targets). Each shard exports a cheap load signal — an
EWMA of its recent scale-lock wait windows (folded by its health loop) plus
the expected wait implied by the current lock queue — and a periodic
rebalancer loop migrates the hottest functions (by per-function creation
heat) from the hottest shard to the coldest whenever the imbalance exceeds
``cp_rebalance_hot_factor``. Everything is deterministic; knobs live in
``DirigentCosts`` (``cp_rebalance_*``, ``cp_steal_backoff``) and are
documented in docs/operations.md.

Per-function creation sharding (``cp_fn_split_enabled``, default off). The
rebalancer moves *whole* functions, so one function whose creation load
alone saturates a scale lock is an irreducible hotspot — no partition of
whole functions fixes it. The escalation generalizes ownership from
``fn→shard`` to ``fn→shard-set``: the indirection-table entry becomes a
tuple (home subshard first), and the function gets one ``FunctionSlice``
per subshard — its own sandbox set, creating count and heat — so each
subshard creates under **its own scale lock** on **its own worker
partition** and flushes endpoints through **its own queue**. The global
``FunctionState`` (one autoscaler state machine, one merged sandbox map)
stays the single source of truth: the home subshard computes the global
desired count once per instant and divides it into per-slice targets by
deterministic round-robin residual assignment (``autoscaler.split_shares``),
so scale-to-zero and eviction reconciles always see a coherent global
replica count. The rebalancer triggers a split when the hot shard's load is
dominated by one function a whole move cannot fix (projected share exceeds
the hot–cold gap), via the migration handoff generalized to shard-sets
(quiesce *all* members in id order → slice → publish the tuple → persist a
``shardmap/<fn>`` shard-set override off the critical path), and merges it
back when slice heat decays below ``cp_fn_split_min_load`` (cooldown on
both edges bounds flapping). ``recover_as_leader`` replays shard-set
overrides, so failover keeps splits.

Metric ingestion from DPs needs no lock in this model (autoscaler windows
are per-function); the urgent fast path reconciles under the function's
owning shard only (all subshards, for a split function). ``cp_shards=1``
(the default) degenerates to exactly the
pre-shard control plane — one lock, one autoscale loop, one health loop, one
flush queue, same event sequence — which tests pin bit-identically against
recorded fig7/fig8 goldens, and with rebalancing off (the default) the
indirection-table path itself is pinned bit-identical to the static-hash CP
at ``cp_shards=4`` (tests/test_cp_sharding.py).
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Generator, List, Optional, Tuple, TYPE_CHECKING

from repro_torch.core.abstractions import (
    Function, Sandbox, SandboxState, WorkerNodeInfo,
)
from repro_torch.core.autoscaler import FunctionAutoscalerState, split_shares
from repro_torch.core.costmodel import DirigentCosts
from repro_torch.core.metrics import Collector
from repro_torch.core.placement import PartitionedPlacer, make_placer
from repro_torch.simcore import Environment, Interrupt, stable_hash

if TYPE_CHECKING:
    from repro_torch.core.cluster import Cluster


@dataclass
class FunctionSlice:
    """One subshard's slice of a *split* function (``cp_fn_split_enabled``).

    The global ``FunctionState`` keeps the authoritative sandbox map and the
    single autoscaler state machine; a slice tracks which of those sandboxes
    this subshard owns, its in-flight creations, its share of the desired
    count (``target``, assigned by the home subshard via round-robin
    residual shares) and its creation heat (the merge signal)."""

    shard_id: int
    sandbox_ids: set = field(default_factory=set)
    creating: int = 0
    heat: float = 0.0
    target: int = 0


@dataclass
class FunctionState:
    function: Function
    autoscaler: FunctionAutoscalerState
    sandboxes: Dict[int, Sandbox] = field(default_factory=dict)
    creating: int = 0
    # rebalancer signals: ``heat`` counts sandbox creations (the scale-lock
    # work a function charges its shard), halved each rebalance tick;
    # ``cooldown_until`` rate-limits re-migrating the same function
    heat: float = 0.0
    cooldown_until: float = 0.0
    # shard-set ownership (None = sole owner, the common case): subshard id
    # -> FunctionSlice while split. ``rr_cursor``/``targets_t`` drive the
    # round-robin residual target assignment; ``split_cooldown_until``
    # applies hysteresis to both the split and the merge edge.
    slices: Optional[Dict[int, FunctionSlice]] = None
    rr_cursor: int = 0
    targets_t: float = -1.0
    split_cooldown_until: float = 0.0

    @property
    def ready_count(self) -> int:
        return sum(1 for s in self.sandboxes.values()
                   if s.state == SandboxState.READY)

    def slice_of(self, sandbox_id: int) -> Optional[FunctionSlice]:
        """The slice owning ``sandbox_id`` (None when unsplit / unowned)."""
        if self.slices:
            for sl in self.slices.values():
                if sandbox_id in sl.sandbox_ids:
                    return sl
        return None

    def slice_ready(self, sl: FunctionSlice) -> int:
        sandboxes = self.sandboxes
        return sum(1 for sid in sl.sandbox_ids
                   if sid in sandboxes
                   and sandboxes[sid].state == SandboxState.READY)

    def drop_sandbox(self, sandbox_id: int) -> Optional[Sandbox]:
        """Remove a sandbox from the global map and its owning slice."""
        sb = self.sandboxes.pop(sandbox_id, None)
        if sb is not None and self.slices:
            for sl in self.slices.values():
                sl.sandbox_ids.discard(sandbox_id)
        return sb


class ControlPlaneShard:
    """One internal CP shard: the state a single shard owner serializes.

    Everything the pre-shard CP guarded with the one global ``_scale_lock``
    lives here, per shard: the scale lock itself, the functions this shard
    autoscales, the last-heartbeat map for the workers it health-checks, and
    the coalescing CP→DP endpoint-update buffer (updates queued in the same
    event-loop turn ride one batched broadcast per shard).

    ``lock_wait_s`` accumulates time processes spent queued on this shard's
    scale lock — the direct measure of the C1 lock convoy that sharding
    removes (exported via monitoring and the churn benchmark).
    """

    __slots__ = ("shard_id", "functions", "worker_last_hb", "scale_lock",
                 "ep_updates", "ep_flush_scheduled", "lock_wait_s",
                 "lock_wait_snap", "load_ema", "steal_backoff_until")

    def __init__(self, env: Environment, shard_id: int):
        self.shard_id = shard_id
        self.functions: Dict[str, FunctionState] = {}
        self.worker_last_hb: Dict[int, float] = {}
        self.scale_lock = env.resource(capacity=1,
                                       name=f"cp-scale-lock-{shard_id}")
        self.ep_updates: Deque[Tuple[str, str, object, bool]] = deque()
        self.ep_flush_scheduled = False
        self.lock_wait_s = 0.0
        # load-signal window marker: lock wait accumulated before the last
        # rebalance tick is history, not current load
        self.lock_wait_snap = 0.0
        # exponentially-weighted lock-wait window (folded by the shard's
        # health loop every worker_heartbeat_period): bursty workloads make
        # a single window phase-noisy — a shard can look idle the tick after
        # its burst drained — so hot/cold ordering and the steal order use
        # this smoothed view
        self.load_ema = 0.0
        # work-stealing backoff: a failed capacity probe of this shard
        # demotes it to the end of the victim order until this instant
        self.steal_backoff_until = 0.0


class ControlPlane:
    def __init__(self, env: Environment, cp_id: int, costs: DirigentCosts,
                 cluster: "Cluster", store, collector: Collector,
                 persist_sandbox_state: bool = False,
                 placement_policy: str = "balanced",
                 cp_shards: int = 1,
                 rebalance_enabled: bool = False,
                 rebalance_period: Optional[float] = None,
                 rebalance_hot_factor: Optional[float] = None,
                 rebalance_max_moves: Optional[int] = None,
                 fn_split_enabled: bool = False,
                 fn_split_max_shards: Optional[int] = None,
                 fn_split_min_load: Optional[float] = None,
                 fn_split_cooldown: Optional[float] = None,
                 ep_flush_coalesce: Optional[bool] = None,
                 incremental_recovery: bool = True,
                 vector_windows: bool = False,
                 batched_eviction: bool = True,
                 checkpoint_enabled: bool = False,
                 checkpoint_period: Optional[float] = None):
        self.env = env
        self.cp_id = cp_id
        self.costs = costs
        self.cluster = cluster
        self.store = store
        self.collector = collector
        self.persist_sandbox_state = persist_sandbox_state
        self.is_leader = False
        self.alive = True
        # global registry: every function the CP knows, across all shards.
        # Shards additionally hold their owned slice (same FunctionState
        # objects) for their autoscale loops.
        self.functions: Dict[str, FunctionState] = {}
        self.workers: Dict[int, WorkerNodeInfo] = {}
        self.placement_policy = placement_policy
        self.cp_shards = max(1, cp_shards)
        self.shards: List[ControlPlaneShard] = [
            ControlPlaneShard(env, k) for k in range(self.cp_shards)]
        # indirection table: function name -> owning shard id. Seeded with
        # ``stable_hash(name) % cp_shards`` at install; the rebalancer may
        # repoint entries (persisted as ``shardmap/<name>`` overrides).
        self.fn_shard_table: Dict[str, int] = {}
        self.placer = self._make_placer()
        # Share the cluster-wide sandbox id counter so ids stay unique across
        # leader epochs (a new leader must not reuse ids already adopted from
        # the deposed one). Standalone CPs fall back to a private counter.
        self._sandbox_ids = getattr(cluster, "_sandbox_ids", None) \
            or itertools.count(1)
        self._loops = []
        self.no_downscale_until = 0.0
        # load-adaptive rebalancing knobs (resolved against the cost model;
        # a single shard has nothing to rebalance)
        self.rebalance_enabled = bool(rebalance_enabled) and self.cp_shards > 1
        self.rebalance_period = (costs.cp_rebalance_period
                                 if rebalance_period is None
                                 else rebalance_period)
        self.rebalance_hot_factor = (costs.cp_rebalance_hot_factor
                                     if rebalance_hot_factor is None
                                     else rebalance_hot_factor)
        self.rebalance_max_moves = (costs.cp_rebalance_max_moves
                                    if rebalance_max_moves is None
                                    else rebalance_max_moves)
        # per-function creation sharding (fn -> shard-set escalation); like
        # rebalancing, meaningless with a single shard
        self.fn_split_enabled = bool(fn_split_enabled) and self.cp_shards > 1
        # clamp: a shard-set needs ≥ 2 members — below that the escalation
        # would select a dominant function every tick (suppressing whole
        # moves for it) yet never be able to split it
        self.fn_split_max_shards = max(2, costs.cp_fn_split_max_shards
                                       if fn_split_max_shards is None
                                       else fn_split_max_shards)
        self.fn_split_min_load = (costs.cp_fn_split_min_load
                                  if fn_split_min_load is None
                                  else fn_split_min_load)
        self.fn_split_cooldown = (costs.cp_fn_split_cooldown
                                  if fn_split_cooldown is None
                                  else fn_split_cooldown)
        self._split_fns: set = set()
        self._migration_inflight = False
        # cross-shard endpoint-flush coalescing: all shards' updates queued
        # in one flush window ride a single combined broadcast (M per-DP
        # deliveries per turn instead of N shards × M DPs). Off by default:
        # the combined flush is one process instead of one per shard, so
        # event counts — and the event-budget pins — shift.
        self.ep_flush_coalesce = (costs.cp_ep_flush_coalesce
                                  if ep_flush_coalesce is None
                                  else ep_flush_coalesce)
        self._ep_flush_pending: List[ControlPlaneShard] = []
        self._ep_flush_scheduled = False
        # incremental failover recovery (recover_as_leader): rebuild the CP
        # per shard, admitting each shard's traffic as its unit completes
        # instead of gating on the full serial replay. A single shard has
        # nothing to parallelize — it takes the serial path.
        self.incremental_recovery = bool(incremental_recovery)
        # array-backed (numpy) autoscaler windows: decision-identical to the
        # deque reference but not bit-identical (pairwise vs sequential
        # summation), so off by default (tests/test_vectorized.py)
        self.vector_windows = bool(vector_windows)
        # batched eviction reconcile: one pass over the functions the dead
        # worker actually hosted instead of every function the owning shard
        # autoscales (legacy path kept as the decision reference)
        self.batched_eviction = bool(batched_eviction)
        # checkpointed recovery: the leader periodically persists a compacted
        # ``checkpoint/<epoch>`` snapshot off the critical path, and
        # recover_as_leader loads snapshot + post-checkpoint delta instead of
        # re-reading the full worker/ prefix. Off by default (the legacy
        # full-prefix replay is what the recovery event-budget pin asserts).
        self.checkpoint_enabled = bool(checkpoint_enabled)
        self.checkpoint_period = (costs.cp_checkpoint_period
                                  if checkpoint_period is None
                                  else checkpoint_period)
        # shard ids still replaying after a failover: traffic to them is not
        # admitted yet (urgent reconciles are deferred to the shard's own
        # autoscale loop, which starts at admission)
        self._recovering_shards: set = set()
        self._recovery_barrier = None

    # -- shard routing ---------------------------------------------------------------
    def _default_shard_id(self, name: str) -> int:
        if self.cp_shards == 1:
            return 0
        return stable_hash(name) % self.cp_shards

    def _fn_shard_id(self, name: str) -> int:
        """Home shard id. Table entries are an ``int`` for a sole owner or a
        tuple (shard-set, home subshard first) for a split function; routing
        that needs *one* shard (ep updates with no slice context, urgent
        reconcile entry, eviction fan-out) goes to the home subshard."""
        k = self.fn_shard_table.get(name)
        if k is None:
            k = self._default_shard_id(name)
        elif type(k) is not int:
            k = k[0]
        return k

    def _fn_shard_ids(self, name: str) -> Tuple[int, ...]:
        """Full owning shard-set (home first); ``(home,)`` when unsplit."""
        k = self.fn_shard_table.get(name)
        if k is None:
            return (self._default_shard_id(name),)
        if type(k) is int:
            return (k,)
        return k

    def _fn_shard(self, name: str) -> ControlPlaneShard:
        if self.cp_shards == 1:
            return self.shards[0]
        return self.shards[self._fn_shard_id(name)]

    def shard_load(self, shard: ControlPlaneShard) -> float:
        """Cheap per-shard load signal (seconds of scale-lock pressure):
        the EWMA of recent lock-wait windows plus the expected wait implied
        by the current lock queue. The window/EWMA maintenance rides the
        shard's health loop (always running on a leader, rebalancing on or
        off), so the work-stealing spill and the ``dirigent_cp_shard_load``
        gauge rank shards by *recent* load — not lifetime history. Shared by
        the rebalancer (hot/cold shard selection) and the work-stealing
        spill (least-loaded victim ordering)."""
        return (shard.load_ema
                + shard.scale_lock.queue_len * self.costs.cp_scale_lock_hold)

    def _worker_shard(self, worker_id: int) -> ControlPlaneShard:
        # same partition as PartitionedPlacer._shard, so the workers a shard
        # health-checks are the workers its placer slice scores
        if self.cp_shards == 1:
            return self.shards[0]
        return self.shards[worker_id % self.cp_shards]

    def _make_placer(self):
        if self.cp_shards > 1:
            # PartitionedPlacer normalizes policy="partitioned" itself
            return PartitionedPlacer(policy=self.placement_policy,
                                     n_shards=self.cp_shards)
        return make_placer(self.placement_policy)

    @property
    def worker_last_hb(self) -> Dict[int, float]:
        """Merged last-heartbeat view across shards (diagnostics/tests)."""
        if self.cp_shards == 1:
            return self.shards[0].worker_last_hb
        merged: Dict[int, float] = {}
        for shard in self.shards:
            merged.update(shard.worker_last_hb)
        return merged

    # -- lifecycle -----------------------------------------------------------------
    def start_leader(self) -> None:
        self.is_leader = True
        self._loops = []
        self._recovering_shards = set()
        for shard in self.shards:
            self._start_shard_loops(shard)
        self._start_global_loops()

    def _start_shard_loops(self, shard: ControlPlaneShard) -> None:
        """Admit one shard: start its autoscale + health loops. Called for
        every shard by ``start_leader``, and per shard by the incremental
        recovery units as each finishes its replay."""
        self._loops.append(self.env.process(
            self._autoscale_loop(shard),
            name=f"cp{self.cp_id}-autoscale-{shard.shard_id}"))
        self._loops.append(self.env.process(
            self._health_loop(shard),
            name=f"cp{self.cp_id}-health-{shard.shard_id}"))

    def _start_global_loops(self) -> None:
        if self.rebalance_enabled or self.fn_split_enabled:
            # the split/merge escalation rides the rebalancer tick; enabling
            # either mechanism starts the loop (each stays gated inside it)
            self._loops.append(self.env.process(
                self._rebalance_loop(),
                name=f"cp{self.cp_id}-rebalance"))
        if self.checkpoint_enabled:
            self._loops.append(self.env.process(
                self._checkpoint_loop(),
                name=f"cp{self.cp_id}-checkpoint"))

    def _checkpoint_loop(self) -> Generator:
        """Leader-only: persist a compacted snapshot every checkpoint period.
        The write itself serializes on the store WAL like any other write —
        off the invocation critical path, but an honest WAL hold."""
        while True:
            yield self.env.timeout(self.checkpoint_period)
            if not (self.alive and self.is_leader):
                return
            yield from self.store.write_checkpoint()
            self.collector.event(self.env.now, "cp-checkpoint",
                                 self.store.checkpoint_epoch)

    def stop(self) -> None:
        self.alive = False
        self.is_leader = False
        for p in self._loops:
            p.kill()
        self._loops = []
        self._recovering_shards = set()
        barrier = getattr(self, "_recovery_barrier", None)
        if barrier is not None:
            self._recovery_barrier = None
            if not barrier.triggered:
                barrier.succeed(None)
        for shard in self.shards:
            shard.ep_updates.clear()
        self._ep_flush_pending.clear()

    # -- user API --------------------------------------------------------------------
    def install_function(self, fn: Function) -> FunctionState:
        """Insert a function into the registry, the indirection table and its
        owning shard, with no modeled cost (registration bypass for
        benchmarks / recovery)."""
        st = FunctionState(function=fn,
                           autoscaler=FunctionAutoscalerState(
                               fn.scaling, vectorized=self.vector_windows))
        k = self.fn_shard_table.setdefault(fn.name,
                                           self._default_shard_id(fn.name))
        if type(k) is not int:
            # re-registering a currently-split function: the fresh state is
            # unsplit, so collapse the shard-set back to its home subshard
            # (consistent table ↔ shard maps; the rebalancer may re-split)
            for sid in k:
                self.shards[sid].functions.pop(fn.name, None)
            self._split_fns.discard(fn.name)
            k = k[0]
            self.fn_shard_table[fn.name] = k
        self.functions[fn.name] = st
        self.shards[k].functions[fn.name] = st
        return st

    def register_function(self, fn: Function) -> Generator:
        """Register: persist the spec, propagate metadata to DPs (paper: ~2 ms)."""
        yield self.env.timeout(self.costs.grpc_call)          # client -> CP
        yield from self.store.write(f"function/{fn.name}", fn.persisted_record())
        self.install_function(fn)
        # propagate to data planes: one batched broadcast covers every DP
        dps = self.cluster.data_planes_alive()
        if dps:
            yield self.env.timeout(self.costs.grpc_call)
            for dp in dps:
                dp.sync_functions([fn.name])
        return fn.name

    def deregister_function(self, name: str) -> Generator:
        yield from self.store.write(f"function/{name}", None)
        st = self.functions.pop(name, None)
        for sid in self._fn_shard_ids(name):
            self.shards[sid].functions.pop(name, None)
        self._split_fns.discard(name)
        k = self.fn_shard_table.pop(name, None)
        if ((self.rebalance_enabled or self.fn_split_enabled)
                and k is not None
                and (type(k) is not int or k != self._default_shard_id(name))):
            # the function had been migrated or split: drop its durable
            # override too
            yield from self.store.write(f"shardmap/{name}", None)
        if st:
            for sb in list(st.sandboxes.values()):
                yield from self._teardown_sandbox(st, sb)

    # -- component registration ---------------------------------------------------------
    def register_worker(self, info: WorkerNodeInfo) -> Generator:
        yield from self.store.write(f"worker/{info.worker_id}",
                                    info.persisted_record())
        self.workers[info.worker_id] = info
        self._worker_shard(info.worker_id).worker_last_hb[info.worker_id] = \
            self.env.now
        self.placer.add_node(info.worker_id, info.cpu_capacity_millis,
                             info.mem_capacity_mb)

    def register_workers_bulk(self, infos: List[WorkerNodeInfo]) -> Generator:
        """Bulk boot registration (group-commit mode): the whole worker log
        lands through ``store.write_many`` in O(batches) group commits, then
        every worker is installed in the same order the serialized loop
        would have used — same workers-map, health-slice and placer insertion
        order, so the two boot paths are equivalence-testable record for
        record."""
        yield from self.store.write_many(
            [(f"worker/{info.worker_id}", info.persisted_record())
             for info in infos])
        for info in infos:
            self.workers[info.worker_id] = info
            self._worker_shard(info.worker_id).worker_last_hb[info.worker_id] \
                = self.env.now
            self.placer.add_node(info.worker_id, info.cpu_capacity_millis,
                                 info.mem_capacity_mb)

    def register_data_plane(self, dp_info) -> Generator:
        yield from self.store.write(f"dataplane/{dp_info.dp_id}",
                                    dp_info.persisted_record())

    # -- metrics ingestion (from DPs) ------------------------------------------------------
    def receive_metric(self, dp_id: int, fn: str, inflight: int,
                       urgent: bool = False) -> Generator:
        yield self.env.timeout(self.costs.grpc_call)
        if not (self.alive and self.is_leader):
            return
        st = self.functions.get(fn)
        if st is None:
            return
        st.autoscaler.record_metric(self.env.now, float(inflight))
        if urgent:
            if (self._recovering_shards
                    and self._fn_shard_id(fn) in self._recovering_shards):
                # mid-recovery: the owning shard has not been admitted yet
                # (its workers may still be replaying — acting now would
                # place against a partial view). Its autoscale loop starts
                # at admission and consumes the window recorded above.
                return
            # Event-driven fast path: a queue formed with zero free slots.
            yield from self._reconcile_function(fn, st)

    def receive_metric_batch(self, dp_id: int, report: Dict[str, int]) -> Generator:
        yield self.env.timeout(self.costs.grpc_call)
        if not (self.alive and self.is_leader):
            return
        for fn, inflight in report.items():
            st = self.functions.get(fn)
            if st is not None:
                st.autoscaler.record_metric(self.env.now, float(inflight))

    def report_dead_sandbox(self, fn: str, sandbox_id: int) -> Generator:
        """A DP dispatched to a sandbox that is gone (killed behind our back,
        e.g. torn down by a deposed leader, or lost with its node). Reconcile
        it out of the cluster state so routing and capacity self-heal —
        sandbox state is reconstructed from cluster signals, never trusted
        blindly (paper §3.4)."""
        yield self.env.timeout(self.costs.grpc_call)   # DP -> CP report
        if not (self.alive and self.is_leader):
            return
        st = self.functions.get(fn)
        if st is None:
            return
        sb = st.drop_sandbox(sandbox_id)
        if sb is None:
            return
        self.placer.release(sb.worker_id,
                            st.function.scaling.cpu_req_millis,
                            st.function.scaling.mem_req_mb)
        self._queue_endpoint_update("remove", fn, sandbox_id, drain=False)
        yield from self._reconcile_function(fn, st)

    def heartbeat(self, worker_id: int) -> None:
        """Worker heartbeat. Touches the owning shard's health/state slice.

        Contention model (C9): heartbeat processing holds the shard's state
        lock for ``cp_heartbeat_lock_hold``. The hold goes through the
        engine's lazy ``Resource.reserve`` — when the lock is free, the
        12 µs critical section costs *zero* heap events; only a beat that
        actually collides with a creation (or another beat) falls back to a
        real process with the same FIFO queueing and ``lock_wait_s``
        accounting the per-beat sub-process model had."""
        if not self.alive:
            return
        shard = self._worker_shard(worker_id)
        shard.worker_last_hb[worker_id] = self.env.now
        lock = shard.scale_lock
        if lock.reserve(self.env.now + self.costs.cp_heartbeat_lock_hold):
            return

        def hb(env):
            t0 = env.now
            yield lock.acquire()
            shard.lock_wait_s += env.now - t0
            try:
                # simlint: ok(held-lock-timeout): modeled C9 heartbeat
                yield env.timeout(self.costs.cp_heartbeat_lock_hold)
            finally:
                lock.release()
        self.env.process(hb(self.env), name="hb-touch")

    def heartbeat_batch(self, worker_ids: List[int]) -> None:
        """Cohort heartbeat (cluster ``hb_cohort_quantum``): the heartbeat
        wheel delivers every beat sharing one quantized deadline as a single
        call, in worker-id order. All ids belong to one CP shard (the wheel
        is per shard), so the C9 contention model becomes ONE contiguous
        lock hold of ``n × cp_heartbeat_lock_hold`` — the same total lock
        time a creation can collide with, without n individual reserves
        landing on the same instant and exploding into n fallback
        sub-processes."""
        if not self.alive or not worker_ids:
            return
        now = self.env.now
        shard = self._worker_shard(worker_ids[0])
        hb_map = shard.worker_last_hb
        for wid in worker_ids:
            hb_map[wid] = now
        hold = self.costs.cp_heartbeat_lock_hold * len(worker_ids)
        lock = shard.scale_lock
        if lock.reserve(now + hold):
            return

        def hb(env):
            t0 = env.now
            yield lock.acquire()
            shard.lock_wait_s += env.now - t0
            try:
                # simlint: ok(held-lock-timeout): modeled C9 cohort hold
                yield env.timeout(hold)
            finally:
                lock.release()
        self.env.process(hb(self.env), name="hb-batch")

    # -- autoscaling ------------------------------------------------------------------------
    def _autoscale_loop(self, shard: ControlPlaneShard) -> Generator:
        while True:
            yield self.env.timeout(self.costs.autoscale_period)
            for fn, st in list(shard.functions.items()):
                yield from self._reconcile_function(fn, st,
                                                    shard_id=shard.shard_id)

    def _reconcile_function(self, fn: str, st: FunctionState,
                            shard_id: Optional[int] = None) -> Generator:
        """Compute desired scale and act on the difference.

        ``shard_id`` is the calling subshard's context (a shard's autoscale
        loop or eviction fan-out); ``None`` means a global caller (urgent
        metric push, dead-sandbox reconcile). Sole owners ignore it; a split
        function acts only on the calling subshard's slice — or on every
        slice for a global caller."""
        yield self.env.timeout(self.costs.cp_sched_cpu)
        self.collector.reconciles += 1
        if st.slices is not None:
            yield from self._reconcile_split(fn, st, shard_id)
            return
        current = st.ready_count + st.creating
        desired = st.autoscaler.desired(self.env.now, current)
        if self.env.now < self.no_downscale_until:
            desired = max(desired, current)     # post-recovery hold (§3.4.1)
        if desired > current:
            for _ in range(desired - current):
                st.creating += 1
                self.env.process(self._create_sandbox(st),
                                 name=f"create-{fn}")
        elif desired < current:
            victims = self._pick_victims(st, current - desired)
            for sb in victims:
                yield from self._teardown_sandbox(st, sb)

    # -- split-function scaling (shard-set ownership) ------------------------------------
    def _split_current(self, st: FunctionState) -> int:
        """Coherent *global* replica count of a split function: every ready
        sandbox (the global map is authoritative) plus in-flight creations —
        per slice, plus any ``st.creating`` leftovers spawned while the
        function was a sole owner (they complete against the global state
        and get adopted into a slice on readiness)."""
        return (st.ready_count + st.creating
                + sum(sl.creating for sl in st.slices.values()))  # simlint: ok(dict-iteration): int sum, order-free

    def _split_targets(self, st: FunctionState) -> None:
        """Recompute per-slice desired shares, at most once per instant.

        One autoscaler state machine serves the whole shard-set: the global
        desired count is computed against the merged replica count (so the
        KPA panic/scale-to-zero logic behaves exactly as for a sole owner)
        and divided into per-slice targets by deterministic round-robin
        residual assignment (``autoscaler.split_shares``); the cursor
        advances by the residual so no subshard permanently carries it.
        Recomputed only by the home subshard's reconcile or a global caller
        — non-home subshards act on their stored target (at most one
        autoscale period stale), which keeps concurrent subshard loops from
        re-deciding the same tick against each other."""
        now = self.env.now
        if st.targets_t == now:
            return
        st.targets_t = now
        slices = st.slices
        current = self._split_current(st)
        desired = st.autoscaler.desired(now, current)
        if now < self.no_downscale_until:
            desired = max(desired, current)     # post-recovery hold (§3.4.1)
        order = sorted(slices)
        shares = split_shares(desired, len(order), st.rr_cursor)
        for i, sid in enumerate(order):
            slices[sid].target = shares[i]
        r = desired % len(order)
        if r:
            st.rr_cursor = (st.rr_cursor + r) % len(order)

    def _reconcile_split(self, fn: str, st: FunctionState,
                         shard_id: Optional[int]) -> Generator:
        home = self._fn_shard_id(fn)
        if shard_id is None or shard_id == home:
            self._split_targets(st)
        if shard_id is not None:
            sl = st.slices.get(shard_id)
            acts = [sl] if sl is not None else []
        else:
            acts = [st.slices[k] for k in sorted(st.slices)]
        desired = sum(s.target for s in st.slices.values())  # simlint: ok(dict-iteration): int sum, order-free
        for sl in acts:
            if st.slices is None or st.slices.get(sl.shard_id) is not sl:
                # the shard-set merged (or re-formed) while a teardown below
                # yielded — the remaining slices no longer exist; the sole-
                # owner path (or the new slices' own reconciles) takes over
                return
            current = st.slice_ready(sl) + sl.creating
            if sl.target > current:
                # cap at the global shortfall: residual rotation between
                # recomputes must not inflate the total replica count
                n = min(sl.target - current,
                        max(0, desired - self._split_current(st)))
                for _ in range(n):
                    sl.creating += 1
                    self.env.process(
                        self._create_sandbox(st, slice_id=sl.shard_id),
                        name=f"create-{fn}")
            elif sl.target < current:
                # symmetric cap: only shed true global excess, so a rotated
                # residual never tears down a replica another slice is
                # creating back
                n = min(current - sl.target,
                        max(0, self._split_current(st) - desired))
                for sb in self._pick_slice_victims(st, sl, n):
                    yield from self._teardown_sandbox(st, sb)

    def _pick_victims(self, st: FunctionState, n: int) -> List[Sandbox]:
        ready = [s for s in st.sandboxes.values()  # simlint: ok(dict-iteration): unique-key sort below erases order
                 if s.state == SandboxState.READY]
        ready.sort(key=lambda s: -s.sandbox_id)    # newest first
        return ready[:n]

    def _pick_slice_victims(self, st: FunctionState, sl: FunctionSlice,
                            n: int) -> List[Sandbox]:
        if n <= 0:
            return []
        # sorted: sandbox_ids is a set; the unique-key sort below erases the
        # iteration order, but a sorted sweep keeps the path replay-stable
        ready = [st.sandboxes[sid] for sid in sorted(sl.sandbox_ids)
                 if sid in st.sandboxes
                 and st.sandboxes[sid].state == SandboxState.READY]
        ready.sort(key=lambda s: -s.sandbox_id)    # newest first
        return ready[:n]

    # -- sandbox creation (the latency-critical path) --------------------------------------------
    def _place(self, shard: ControlPlaneShard, cpu: int, mem: int) -> Generator:
        """Pick a worker for ``shard``'s new sandbox.

        Single-shard CPs score the whole cluster (pre-shard behavior).
        Sharded CPs score their own placer partition — the workers this same
        shard health-checks — so the hot path never leaves the shard; only
        when the shard's workers are full does the placement spill to foreign
        partitions, paying ``cp_cross_shard_op`` per shard probed.

        The spill is *work stealing*: victims are probed least-loaded-first
        by ``shard_load`` (the rebalancer's signal), so a convoy never forms
        on one deterministic victim. A probe that finds no capacity back-offs
        its shard (``cp_steal_backoff``) to the end of the order; ties and
        fully backed-off clusters fall back to the round-robin offset order,
        so a saturated cluster degrades to the pre-steal probe sequence."""
        if self.cp_shards == 1:
            return self.placer.place(cpu, mem)
        k = shard.shard_id
        wid = self.placer.shards[k].place(cpu, mem)
        if wid is not None:
            return wid
        now = self.env.now
        shards = self.shards

        def steal_rank(off: int) -> Tuple[bool, float, int]:
            victim = shards[(k + off) % self.cp_shards]
            return (victim.steal_backoff_until > now,
                    self.shard_load(victim), off)

        for off in sorted(range(1, self.cp_shards), key=steal_rank):
            yield self.env.timeout(self.costs.cp_cross_shard_op)
            self.collector.steal_probes += 1
            victim_id = (k + off) % self.cp_shards
            wid = self.placer.shards[victim_id].place(cpu, mem)
            if wid is not None:
                self.collector.steals += 1
                return wid
            shards[victim_id].steal_backoff_until = \
                self.env.now + self.costs.cp_steal_backoff
        return None

    def _live_slice(self, st: FunctionState, slice_id: Optional[int],
                    sl: Optional[FunctionSlice]) -> bool:
        """Is ``sl`` still the live slice for ``slice_id``? False once the
        shard-set merged (or re-split: a new object under the same id)."""
        return (sl is not None and st.slices is not None
                and st.slices.get(slice_id) is sl)

    def _create_sandbox(self, st: FunctionState,
                        slice_id: Optional[int] = None) -> Generator:
        fn = st.function
        # slice context: a creation spawned for a split function runs against
        # its subshard's lock/partition. If the split dissolved before we got
        # scheduled, fall back to the sole-owner path (the merge already
        # folded our CREATING count into st.creating).
        sl = (st.slices.get(slice_id)
              if slice_id is not None and st.slices is not None else None)
        if sl is None:
            slice_id = None
        # rebalancer heat: one creation = one scale-lock hold charged to the
        # owning (sub)shard on this function's behalf (decayed each tick)
        if sl is None:
            st.heat += 1.0
        else:
            sl.heat += 1.0
        try:
            # the shard's slice of the autoscaling/cluster-state structures
            # (C1 bottleneck; global when cp_shards == 1). A migration
            # handoff may repoint the function while we queue on the lock —
            # re-check ownership after acquiring and chase the function to
            # its new shard, so a creation never runs against a slice the
            # function left (once we hold the current owner's lock, a
            # further move is impossible: the handoff needs this lock too).
            # A split creation re-checks its slice instead: a merge handoff
            # needs every subshard lock, so holding ours pins the slice.
            while True:
                if sl is not None and not self._live_slice(st, slice_id, sl):
                    sl, slice_id = None, None   # merged away while queued
                shard = (self.shards[slice_id] if sl is not None
                         else self._fn_shard(fn.name))
                t0 = self.env.now
                yield shard.scale_lock.acquire()
                shard.lock_wait_s += self.env.now - t0
                if sl is not None:
                    if self._live_slice(st, slice_id, sl):
                        break
                elif self._fn_shard(fn.name) is shard:
                    break
                shard.scale_lock.release()
            try:
                # simlint: ok(held-lock-timeout): modeled scale-lock hold
                yield self.env.timeout(self.costs.cp_scale_lock_hold)
                wid = yield from self._place(shard, fn.scaling.cpu_req_millis,
                                             fn.scaling.mem_req_mb)
            finally:
                shard.scale_lock.release()
            if wid is None:
                return  # no capacity in the cluster

            sb = Sandbox(
                sandbox_id=next(self._sandbox_ids),
                function_name=fn.name,
                ip=self.workers[wid].ip, port=fn.port, worker_id=wid,
            )
            st.sandboxes[sb.sandbox_id] = sb
            if sl is not None and self._live_slice(st, slice_id, sl):
                sl.sandbox_ids.add(sb.sandbox_id)

            if self.persist_sandbox_state:
                # ABLATION: durable write on the critical path (paper §5.2.1
                # "optimization breakdown") — this is what Dirigent removes.
                yield from self.store.write(f"sandbox/{sb.key}", sb.to_bytes())

            worker = self.cluster.worker_by_id(wid)
            yield self.env.timeout(self.costs.grpc_call)   # CP -> worker
            try:
                yield self.env.process(worker.create_sandbox(sb),
                                       name=f"boot-{sb.key}")
            except (RuntimeError, Interrupt):
                st.drop_sandbox(sb.sandbox_id)
                self.placer.release(wid, fn.scaling.cpu_req_millis,
                                    fn.scaling.mem_req_mb)
                return
            yield self.env.timeout(self.costs.grpc_call)   # ready notification
            if not (self.alive and self.is_leader):
                # leadership lost while the worker booted: this replica's
                # in-memory view is dead weight — undo the placement commit
                # and drop the CREATING record so capacity stays exact
                st.drop_sandbox(sb.sandbox_id)
                self.placer.release(wid, fn.scaling.cpu_req_millis,
                                    fn.scaling.mem_req_mb)
                return
            sb.state = SandboxState.READY
            if (st.slices is not None
                    and not self._live_slice(st, slice_id, sl)
                    and st.slice_of(sb.sandbox_id) is None):
                # a sole-owner leftover (or a creation whose slice dissolved
                # and re-split) finishing against a split function: adopt it
                # into a slice so per-slice accounting stays coherent —
                # unless a split handoff that ran mid-boot already
                # partitioned this (then-CREATING) sandbox into a slice
                self._adopt_sandbox(st, sb)
            self.collector.sandbox_creations += 1
            self.collector.event(self.env.now, "sandbox-created", fn.name)
            # in-memory state update; the endpoint rides the next coalesced
            # broadcast (one batched grpc_call for all DPs and all updates
            # queued this turn on this shard)
            yield self.env.timeout(self.costs.channel_op)
            # a split creation's endpoint flushes through the subshard that
            # created it (exactly-once per subshard); sole owners keep the
            # owning-shard routing
            self._queue_endpoint_update(
                "add", fn.name, sb,
                shard=shard if sl is not None else None)
        finally:
            if self._live_slice(st, slice_id, sl):
                sl.creating = max(0, sl.creating - 1)
            else:
                st.creating = max(0, st.creating - 1)

    def _adopt_sandbox(self, st: FunctionState, sb: Sandbox) -> None:
        """Attach an unowned sandbox of a split function to a slice: the
        subshard whose worker partition hosts it, else the home subshard."""
        sl = st.slices.get(sb.worker_id % self.cp_shards)
        if sl is None:
            sl = st.slices[self._fn_shard_id(st.function.name)]
        sl.sandbox_ids.add(sb.sandbox_id)

    def _teardown_sandbox(self, st: FunctionState, sb: Sandbox) -> Generator:
        # teardown runs in the asynchronous autoscaling loop, off the
        # latency-critical path (paper §4 "Sandbox teardown") — it does not
        # contend the scale lock
        yield self.env.timeout(self.costs.channel_op)
        owner_slice = st.slice_of(sb.sandbox_id)   # before the drop
        if st.sandboxes.pop(sb.sandbox_id, None) is None:
            # a concurrent remover (dead-sandbox report, worker eviction,
            # another reconcile) already took it: releasing again would
            # free phantom capacity and overcommit the node
            return
        if owner_slice is not None:
            owner_slice.sandbox_ids.discard(sb.sandbox_id)
        sb.state = SandboxState.TERMINATING
        if self.persist_sandbox_state:
            yield from self.store.write(f"sandbox/{sb.key}", None)
        # a split replica's removal rides its owning subshard's flush queue
        self._queue_endpoint_update(
            "remove", st.function.name, sb.sandbox_id,
            shard=(self.shards[owner_slice.shard_id]
                   if owner_slice is not None else None))
        worker = self.cluster.worker_by_id(sb.worker_id)
        if worker is not None:
            # drain grace: in-flight requests already dispatched to this
            # sandbox finish before the worker dismantles it
            def drain_then_kill(env, worker=worker, sid=sb.sandbox_id):
                yield env.timeout(self.costs.teardown_drain_grace)
                if not (self.alive and self.is_leader):
                    # the kill RPC was never sent: the CP died (or was
                    # deposed) during the drain grace. The sandbox stays up
                    # at the worker; the next leader re-adopts it from the
                    # worker push and owns its lifecycle from there.
                    return
                yield from worker.kill_sandbox(sid)
            self.env.process(drain_then_kill(self.env),
                             name=f"kill-{sb.key}")
        self.placer.release(sb.worker_id,
                            st.function.scaling.cpu_req_millis,
                            st.function.scaling.mem_req_mb)
        self.collector.sandbox_teardowns += 1

    # -- CP -> DP endpoint propagation (coalesced, per shard) -------------------------------------
    def _queue_endpoint_update(self, op: str, fn: str, payload,
                               drain: bool = True,
                               shard: Optional[ControlPlaneShard] = None,
                               ) -> None:
        """Buffer an endpoint add/remove on the function's owning shard —
        or, for a split function's replicas, on the subshard passed by the
        caller (each subshard flushes its own creations/teardowns exactly
        once); every update queued on a shard in the same event-loop turn
        shares one batched broadcast to all DPs."""
        if shard is None:
            shard = self._fn_shard(fn)
        shard.ep_updates.append((op, fn, payload, drain))
        self._schedule_ep_flush(shard)

    def _schedule_ep_flush(self, shard: ControlPlaneShard) -> None:
        if shard.ep_flush_scheduled:
            return
        shard.ep_flush_scheduled = True
        if self.ep_flush_coalesce:
            # cross-shard coalescing: park the shard on the pending list;
            # one combined flush per turn drains every pending shard, so N
            # shards × M DPs costs M per-DP deliveries, not N×M
            self._ep_flush_pending.append(shard)
            if not self._ep_flush_scheduled:
                self._ep_flush_scheduled = True
                self.env.process(
                    self._flush_endpoint_updates_combined(),
                    name=f"cp{self.cp_id}-ep-flush-all")
            return
        self.env.process(
            self._flush_endpoint_updates(shard),
            name=f"cp{self.cp_id}-ep-flush-{shard.shard_id}")

    def _flush_endpoint_updates(self, shard: ControlPlaneShard) -> Generator:
        yield self.env.timeout(self.costs.grpc_call)   # one batched broadcast
        updates, shard.ep_updates = shard.ep_updates, deque()
        shard.ep_flush_scheduled = False
        if not self.alive:
            return
        dps = self.cluster.data_planes_alive()
        self._apply_ep_updates(updates, dps)

    def _flush_endpoint_updates_combined(self) -> Generator:
        """Coalesced variant (``ep_flush_coalesce``): one broadcast carries
        every pending shard's updates, in shard scheduling order — the
        per-update apply order is identical to the per-shard flushes, they
        just share the wire."""
        yield self.env.timeout(self.costs.grpc_call)   # one combined broadcast
        pending, self._ep_flush_pending = self._ep_flush_pending, []
        self._ep_flush_scheduled = False
        batch: List[tuple] = []
        for shard in pending:
            updates, shard.ep_updates = shard.ep_updates, deque()
            shard.ep_flush_scheduled = False
            batch.extend(updates)
        if not self.alive:
            return
        dps = self.cluster.data_planes_alive()
        self._apply_ep_updates(batch, dps)

    def _apply_ep_updates(self, updates, dps) -> None:
        # leadership is stable for the whole batch (pure synchronous applies,
        # no yield): hoist the per-update check out of the per-creation loop
        is_leader = self.is_leader
        for op, fn, payload, drain in updates:
            if op == "add":
                # a dethroned leader must not introduce endpoints...
                if is_leader:
                    for dp in dps:
                        dp.add_endpoint(fn, payload)
            else:
                # ...but removes are always safe: the sandbox is being killed
                # regardless, and dropping them here would strand a dead
                # endpoint in the DP caches
                for dp in dps:
                    dp.remove_endpoint(fn, payload, drain=drain)

    # -- health monitoring (per shard) -------------------------------------------------------------
    def _health_loop(self, shard: ControlPlaneShard) -> Generator:
        c = self.costs
        while True:
            yield self.env.timeout(c.worker_heartbeat_period)
            # fold the lock-wait window into the shard's load EWMA here —
            # pure arithmetic piggybacked on an existing tick (no new
            # events, so cp_shards=1 stays bit-identical) that runs whether
            # or not the rebalancer is enabled: stealing and monitoring see
            # recent load, not lifetime history
            window = shard.lock_wait_s - shard.lock_wait_snap
            shard.lock_wait_snap = shard.lock_wait_s
            shard.load_ema = 0.7 * shard.load_ema + window
            now = self.env.now
            for wid, last in list(shard.worker_last_hb.items()):
                if now - last > c.worker_heartbeat_timeout:
                    yield from self._evict_worker(shard, wid)

    def _evict_worker(self, shard: ControlPlaneShard, wid: int) -> Generator:
        """Worker declared dead by its owning shard: stop routing, reschedule
        its sandboxes. The dead worker may host sandboxes of functions owned
        by *other* shards (cross-shard capacity spill), so replacing lost
        capacity is an explicit cross-shard fan-out: this shard reconciles
        its own functions inline, and hands each foreign shard that owned an
        affected function a targeted reconcile message (``cp_cross_shard_op``
        each)."""
        shard.worker_last_hb.pop(wid, None)
        self.placer.set_schedulable(wid, False)
        affected: List[tuple] = []
        for fn, st in self.functions.items():
            for sb in [s for s in st.sandboxes.values() if s.worker_id == wid]:
                owner_slice = st.slice_of(sb.sandbox_id)
                st.sandboxes.pop(sb.sandbox_id, None)
                if owner_slice is not None:
                    owner_slice.sandbox_ids.discard(sb.sandbox_id)
                affected.append((fn, sb.sandbox_id,
                                 None if owner_slice is None
                                 else owner_slice.shard_id))
        foreign: Dict[int, List[str]] = {}
        for fn, sid, slice_shard in affected:
            # a split function's lost replica is the owning *subshard's* to
            # handle — its endpoint removal rides that slice's flush queue,
            # and the reconcile fan-out targets the slice, not just the home
            owner = (self.shards[slice_shard] if slice_shard is not None
                     else self._fn_shard(fn))
            self._queue_endpoint_update(
                "remove", fn, sid, drain=False,
                shard=self.shards[slice_shard] if slice_shard is not None
                else None)
            if owner is not shard and fn not in foreign.get(owner.shard_id, ()):
                foreign.setdefault(owner.shard_id, []).append(fn)
        self.collector.event(self.env.now, "worker-evicted", wid)
        # re-run autoscaling promptly to replace lost capacity: own functions
        # inline in the health loop (pre-shard behavior when cp_shards == 1)...
        if self.batched_eviction:
            # ...batched: one pass over the own-shard functions that actually
            # lost a replica, in eviction-scan order. Unaffected functions
            # gain nothing from an early reconcile (their replica set did not
            # change; the shard's own autoscale loop covers them), and at
            # 20k+ workers an eviction storm must not re-reconcile every
            # function the shard owns once per dead worker.
            own_affected: List[str] = []
            seen_own: set = set()
            for fn, _sid, slice_shard in affected:
                owner_id = (slice_shard if slice_shard is not None
                            else self._fn_shard_id(fn))
                if owner_id == shard.shard_id and fn not in seen_own:
                    seen_own.add(fn)
                    own_affected.append(fn)
            for fn in own_affected:
                st = shard.functions.get(fn)
                if st is not None:
                    yield from self._reconcile_function(fn, st,
                                                        shard_id=shard.shard_id)
        else:
            # legacy reference path: reconcile every own-shard function
            # (tests/test_vectorized.py pins decision identity against it)
            for fn, st in list(shard.functions.items()):
                yield from self._reconcile_function(fn, st,
                                                    shard_id=shard.shard_id)
        # ...affected foreign-owned functions (cross-shard capacity spills)
        # via explicit targeted fan-out; everything else is covered by each
        # shard's own autoscale loop
        for shard_id, fns in foreign.items():
            self.env.process(
                self._cross_shard_reconcile(self.shards[shard_id], fns),
                name=f"cp{self.cp_id}-xshard-{shard_id}")

    def _cross_shard_reconcile(self, shard: ControlPlaneShard,
                               fns: List[str]) -> Generator:
        yield self.env.timeout(self.costs.cp_cross_shard_op)
        for fn in fns:
            st = shard.functions.get(fn)
            if st is None:
                continue
            # unlike the health/autoscale loops, fan-out processes are not in
            # self._loops, so stop() does not kill them — a deposed leader
            # must not keep scaling sandboxes on the shared workers
            if not (self.alive and self.is_leader):
                return
            yield from self._reconcile_function(fn, st,
                                                shard_id=shard.shard_id)

    def restore_worker(self, wid: int) -> None:
        self._worker_shard(wid).worker_last_hb[wid] = self.env.now
        self.placer.set_schedulable(wid, True)

    # -- load-adaptive shard rebalancing -----------------------------------------------------
    def _rebalance_loop(self) -> Generator:
        """Periodic hot-shard rebalancer (``cp_rebalance_enabled``).

        Each tick: read every shard's smoothed load (the health loops fold
        lock-wait windows into a per-shard EWMA — bursty workloads make a
        single window phase-noisy), and — when the hottest shard's load
        exceeds ``cp_rebalance_hot_factor`` times the coldest's — migrate
        its hottest functions to the coldest shard. Function heat halves
        each tick so the signal tracks *recent* creations. Only one
        migration handoff is in flight at a time; everything is
        deterministic (ties break on shard id / function name)."""
        c = self.costs
        while True:
            yield self.env.timeout(self.rebalance_period)
            if self._migration_inflight:
                self._decay_heat()
                continue
            # merge escalation first: a split function whose heat decayed
            # away folds back to its home shard regardless of the hot/cold
            # gates below (a cooled cluster never trips them)
            if self.fn_split_enabled and self._maybe_merge():
                self._decay_heat()
                continue
            # the load EWMA itself is maintained by each shard's health loop
            loads = [(self.shard_load(s), s.shard_id) for s in self.shards]
            hot_load, hot_id = max(loads, key=lambda x: (x[0], -x[1]))
            cold_load, cold_id = min(loads)
            if (hot_id == cold_id or hot_load < c.cp_rebalance_min_load
                    or hot_load <= self.rebalance_hot_factor * cold_load):
                self._decay_heat()
                continue
            hot = self.shards[hot_id]
            total_heat = sum(self._shard_fn_heat(st, hot_id)
                             for st in hot.functions.values())  # simlint: ok(dict-iteration): float sum; install order is deterministic
            # second gate, in *heat* (creation-count) terms: lock wait is
            # superlinear near saturation, so the wait ratio alone can trip
            # on a small real load gap (classic with 2 shards) and migration
            # then just ping-pongs the hotspot. Heat is linear in load —
            # require the same factor there before moving anything.
            cold_heat = sum(self._shard_fn_heat(st, cold_id)
                            for st in self.shards[cold_id].functions.values())  # simlint: ok(dict-iteration): float sum; install order is deterministic
            if total_heat <= self.rebalance_hot_factor * cold_heat:
                self._decay_heat()
                continue
            names: List[str] = []
            split_name: Optional[str] = None
            moved_heat = 0.0
            if total_heat > 0.0:
                gap = hot_load - cold_load
                movers = sorted(
                    ((name, st) for name, st in hot.functions.items()  # simlint: ok(dict-iteration): unique (heat, name) sort key erases order
                     if st.slices is None),   # split fns are already spread
                    key=lambda kv: (-kv[1].heat, kv[0]))
                now = self.env.now
                # split escalation: when the hot shard's heat is dominated
                # by its single hottest function, no whole-function move
                # fixes the convoy — either the projected share exceeds the
                # hot-cold gap outright (moving it inverts the hotspot), or
                # it holds the majority of the shard's heat (moving it to an
                # idle shard merely *relocates* ~all the load and the pair
                # ping-pongs on the cooldown). Split it across a shard-set
                # instead, and skip whole moves this tick: the dominant
                # function IS the imbalance.
                if self.fn_split_enabled and movers:
                    name0, st0 = movers[0]
                    fn_load0 = hot_load * st0.heat / total_heat
                    if (st0.heat > 0.0 and now >= st0.split_cooldown_until
                            and (fn_load0 >= gap
                                 or st0.heat >= 0.5 * total_heat)):
                        split_name = name0
                if split_name is None:
                    # move hottest-first, but only functions whose projected
                    # load share still closes the hot-cold gap — moving a
                    # function whose share exceeds the remaining gap would
                    # just relocate (or invert) the hotspot
                    for name, st in movers:
                        if (len(names) >= self.rebalance_max_moves
                                or st.heat <= 0):
                            break
                        if now < st.cooldown_until:
                            continue
                        fn_load = hot_load * st.heat / total_heat
                        if fn_load >= gap:
                            continue
                        names.append(name)
                        moved_heat += st.heat
                        gap -= 2.0 * fn_load
            self._decay_heat()
            if split_name is not None:
                # second escalation: the hot shard's load is dominated by
                # one function no whole move can fix — split it across its
                # home plus the coldest (k-1) sibling shards
                k = min(self.fn_split_max_shards, self.cp_shards)
                others = sorted((ld, sid) for ld, sid in loads
                                if sid != hot_id)
                shard_ids = ((hot_id,)
                             + tuple(sid for _, sid in others[:k - 1]))
                if len(shard_ids) >= 2:
                    self._migration_inflight = True
                    self.env.process(
                        self._split_function(split_name, shard_ids),
                        name=f"cp{self.cp_id}-split-{split_name}")
            elif self.rebalance_enabled and names:
                self._migration_inflight = True
                self.env.process(
                    self._migrate_functions(
                        hot, self.shards[cold_id], names,
                        ema_delta=hot.load_ema * moved_heat / total_heat),
                    name=f"cp{self.cp_id}-migrate-{hot_id}-{cold_id}")

    def _shard_fn_heat(self, st: FunctionState, shard_id: int) -> float:
        """Creation heat ``st`` charges shard ``shard_id``: the slice's heat
        for a split function (its global heat is spread over the set)."""
        if st.slices is not None:
            sl = st.slices.get(shard_id)
            return sl.heat if sl is not None else 0.0
        return st.heat

    def _decay_heat(self) -> None:
        for shard in self.shards:
            for st in shard.functions.values():
                if st.slices is not None:
                    sl = st.slices.get(shard.shard_id)
                    if sl is not None:
                        sl.heat *= 0.5
                else:
                    st.heat *= 0.5

    def _migrate_functions(self, src: ControlPlaneShard,
                           dst: ControlPlaneShard,
                           names: List[str],
                           ema_delta: float = 0.0) -> Generator:
        """Explicit migration handoff: quiesce → move → publish → persist.

        Quiesce takes *both* shards' scale locks (in shard-id order, so two
        concurrent handoffs cannot deadlock) — no creation can run against
        either slice while function state moves. The move carries the
        ``FunctionState`` and any endpoint-flush entries still queued for the
        function, then repoints the indirection table. The durable
        ``shardmap/`` override is written only after the locks are released —
        persistence stays off the critical path (paper §3.2), and
        ``recover_as_leader`` replays it so failover keeps the adapted
        partition. A deposed leader aborts without touching shared state."""
        moved: List[str] = []
        try:
            if not (self.alive and self.is_leader):
                return
            first, second = sorted((src, dst), key=lambda s: s.shard_id)
            t0 = self.env.now
            yield first.scale_lock.acquire()
            first.lock_wait_s += self.env.now - t0
            t0 = self.env.now
            yield second.scale_lock.acquire()
            second.lock_wait_s += self.env.now - t0
            try:
                # the handoff hop itself (one cross-shard message)
                # simlint: ok(held-lock-timeout): quiesce hold, id-sorted
                yield self.env.timeout(self.costs.cp_cross_shard_op)
                if not (self.alive and self.is_leader):
                    return
                for name in names:
                    st = src.functions.get(name)
                    if st is None or st.slices is not None:
                        # deregistered/moved since selection — or split into
                        # a shard-set, which only the merge handoff may undo
                        continue
                    src.functions.pop(name)
                    dst.functions[name] = st
                    self.fn_shard_table[name] = dst.shard_id
                    st.cooldown_until = (self.env.now
                                         + self.costs.cp_rebalance_cooldown)
                    moved.append(name)
                if moved:
                    # feed the move forward into the smoothed load signal so
                    # the next ticks don't keep draining the same (now
                    # lighter) shard while its EMA still carries the
                    # pre-migration convoy — scaled by what actually moved
                    # (a function deregistered while we queued on the locks
                    # transfers nothing)
                    if ema_delta > 0.0:
                        delta = ema_delta * len(moved) / len(names)
                        src.load_ema -= delta
                        dst.load_ema += delta
                    moved_set = set(moved)
                    carried = [u for u in src.ep_updates
                               if u[1] in moved_set]
                    if carried:
                        # pending endpoint-flush entries follow their function
                        src.ep_updates = deque(
                            u for u in src.ep_updates
                            if u[1] not in moved_set)
                        dst.ep_updates.extend(carried)
                        self._schedule_ep_flush(dst)
                    self.collector.fn_migrations += len(moved)
                    self.collector.event(
                        self.env.now, "fn-migrated",
                        (src.shard_id, dst.shard_id, tuple(moved)))
            finally:
                second.scale_lock.release()
                first.scale_lock.release()
            # durable indirection-table overrides, off the critical path. A
            # move back to the hash-default shard tombstones the override
            # instead (shardmap/ holds only true deviations, so deregister's
            # cleanup check stays exact); a function deregistered while we
            # persisted is skipped rather than resurrected as an orphan.
            for name in moved:
                if not (self.alive and self.is_leader):
                    return
                if name not in self.functions:
                    continue
                value = (None if dst.shard_id == self._default_shard_id(name)
                         else str(dst.shard_id).encode())
                yield from self.store.write(f"shardmap/{name}", value)
        finally:
            self._migration_inflight = False

    # -- per-function creation sharding (split / merge handoffs) ------------------------------
    def _maybe_merge(self) -> bool:
        """Fold one cooled-down split function per tick. Merge when the
        shard-set's summed slice heat decays below ``cp_fn_split_min_load``
        and the split cooldown elapsed (hysteresis against flap)."""
        now = self.env.now
        for name in sorted(self._split_fns):
            st = self.functions.get(name)
            if st is None or st.slices is None:
                self._split_fns.discard(name)
                return False          # stale entry reaped; retry next tick
            if now < st.split_cooldown_until:
                continue
            if (sum(sl.heat for sl in st.slices.values())  # simlint: ok(dict-iteration): slice-map insertion order is deterministic
                    >= self.fn_split_min_load):
                continue
            self._migration_inflight = True
            self.env.process(self._merge_function(name),
                             name=f"cp{self.cp_id}-merge-{name}")
            return True
        return False

    def _split_function(self, name: str,
                        shard_ids: Tuple[int, ...]) -> Generator:
        """Split handoff, the migration handoff generalized to a shard-set:
        quiesce *every* member shard's scale lock (in id order — concurrent
        handoffs cannot deadlock) → slice the ``FunctionState`` (existing
        sandboxes round-robin across the set, heat spread evenly, slice
        targets seeded to current ownership so nothing churns before the
        next autoscale decision) → publish the tuple in the indirection
        table and register the function with every member shard → persist
        the ``shardmap/<fn>`` shard-set override off the critical path.
        ``shard_ids`` is home-first. A deposed leader aborts without
        touching shared state."""
        try:
            if not (self.alive and self.is_leader):
                return
            members = [self.shards[k] for k in sorted(shard_ids)]
            for sh in members:
                t0 = self.env.now
                yield sh.scale_lock.acquire()
                sh.lock_wait_s += self.env.now - t0
            try:
                # one cross-shard hop per subshard recruited
                # simlint: ok(held-lock-timeout): quiesce hold, id-sorted
                yield self.env.timeout(
                    self.costs.cp_cross_shard_op * (len(shard_ids) - 1))
                if not (self.alive and self.is_leader):
                    return
                st = self.functions.get(name)
                if (st is None or st.slices is not None
                        or self._fn_shard_id(name) != shard_ids[0]):
                    return            # deregistered/moved/split since selection
                slices = {k: FunctionSlice(shard_id=k) for k in shard_ids}
                order = sorted(shard_ids)
                for i, sid in enumerate(sorted(st.sandboxes)):
                    slices[order[i % len(order)]].sandbox_ids.add(sid)
                for sl in slices.values():  # simlint: ok(dict-iteration): slice-map insertion order is deterministic
                    sl.target = len(sl.sandbox_ids)
                    sl.heat = st.heat / len(shard_ids)
                st.heat = 0.0
                st.rr_cursor = 0
                st.targets_t = -1.0
                st.slices = slices
                st.split_cooldown_until = (self.env.now
                                           + self.fn_split_cooldown)
                for k in shard_ids:
                    self.shards[k].functions[name] = st
                self.fn_shard_table[name] = tuple(shard_ids)
                self._split_fns.add(name)
                self.collector.fn_splits += 1
                self.collector.event(self.env.now, "fn-split",
                                     (name, tuple(shard_ids)))
            finally:
                for sh in reversed(members):
                    sh.scale_lock.release()
            # durable shard-set override, off the critical path; skipped if
            # the function vanished (or merged back) while we persisted
            if not (self.alive and self.is_leader):
                return
            st = self.functions.get(name)
            if st is None or st.slices is None:
                return
            value = ",".join(str(k) for k in shard_ids).encode()
            yield from self.store.write(f"shardmap/{name}", value)
        finally:
            self._migration_inflight = False

    def _merge_function(self, name: str) -> Generator:
        """Merge handoff: quiesce every subshard lock (id order) → fold the
        slices back into the global ``FunctionState`` (creating counts and
        heat sum; the sandbox map was global all along) → pending
        endpoint-flush entries still queued on non-home subshards move to
        the home queue exactly once → repoint the table to the home shard →
        persist the override (tombstoned when home is the hash default)."""
        try:
            if not (self.alive and self.is_leader):
                return
            st = self.functions.get(name)
            if st is None or st.slices is None:
                return
            home = self._fn_shard_id(name)
            member_ids = sorted(st.slices)
            members = [self.shards[k] for k in member_ids]
            for sh in members:
                t0 = self.env.now
                yield sh.scale_lock.acquire()
                sh.lock_wait_s += self.env.now - t0
            try:
                # simlint: ok(held-lock-timeout): quiesce hold, id-sorted
                yield self.env.timeout(
                    self.costs.cp_cross_shard_op * (len(member_ids) - 1))
                if not (self.alive and self.is_leader):
                    return
                st = self.functions.get(name)
                if st is None or st.slices is None:
                    return            # deregistered/merged since selection
                st.creating += sum(sl.creating for sl in st.slices.values())  # simlint: ok(dict-iteration): int sum, order-free
                st.heat += sum(sl.heat for sl in st.slices.values())  # simlint: ok(dict-iteration): slice-map insertion order is deterministic
                st.slices = None
                st.split_cooldown_until = (self.env.now
                                           + self.fn_split_cooldown)
                survivor = self.shards[home]
                carried: List[tuple] = []
                for k in member_ids:
                    if k == home:
                        continue
                    sh = self.shards[k]
                    sh.functions.pop(name, None)
                    mine = [u for u in sh.ep_updates if u[1] == name]
                    if mine:
                        sh.ep_updates = deque(u for u in sh.ep_updates
                                              if u[1] != name)
                        carried.extend(mine)
                if carried:
                    survivor.ep_updates.extend(carried)
                    self._schedule_ep_flush(survivor)
                self.fn_shard_table[name] = home
                self._split_fns.discard(name)
                self.collector.fn_merges += 1
                self.collector.event(self.env.now, "fn-merged", (name, home))
            finally:
                for sh in reversed(members):
                    sh.scale_lock.release()
            if not (self.alive and self.is_leader):
                return
            if name not in self.functions:
                return
            value = (None if home == self._default_shard_id(name)
                     else str(home).encode())
            yield from self.store.write(f"shardmap/{name}", value)
        finally:
            self._migration_inflight = False

    # -- failover recovery (new leader) ----------------------------------------------------------
    def recover_as_leader(self) -> Generator:
        """Paper §3.4.1: fetch persisted records, reconnect, reconstruct
        sandbox state from worker nodes asynchronously. Rebuilds every
        shard's function/worker maps from the persisted records — including
        the shard indirection table: install seeds hash defaults, then the
        persisted ``shardmap/`` overrides are replayed so a failover does not
        silently undo the rebalancer's migrations.

        The replay itself is *costed per record* (``cp_cross_shard_op`` per
        function / override / worker — each is an in-memory state-machine
        step): at 20k workers the rebuild is tens of milliseconds of real
        work, not a free dict comprehension. Two shapes:

        * **serial** (``incremental_recovery=False``, or a single shard):
          one pass replays everything, then every shard is admitted at once
          — the pre-incremental behavior, kept as the baseline the
          ``failover_scale`` sweep measures against.
        * **incremental** (default, ``cp_shards > 1``): the snapshot read
          below bounds the replay, then one recovery *unit per shard*
          replays that shard's slice of the snapshot concurrently and admits
          the shard (health + autoscale loops, worker merges) the moment its
          own slice is rebuilt — traffic to shard k never waits for shard
          j's replay. Function replay completes on every unit before any
          worker merge starts (a barrier), so pushed sandbox lists never
          race a half-built function table.
        """
        c = self.costs
        yield self.env.timeout(c.cp_recovery_db_fetch)
        # one consistent snapshot bounds the replay: everything written
        # after this point belongs to the new leader's own epoch and is
        # handled by the live loops, not the recovery units
        ckpt = None
        if self.checkpoint_enabled:
            ckpt = yield from self.store.read_checkpoint()
        if ckpt is not None:
            # checkpointed recovery: one compacted snapshot record + the
            # post-checkpoint delta, instead of full-prefix scans. Records
            # sourced from the snapshot bulk-load at
            # cp_snapshot_load_per_record in the units below; only the delta
            # pays the per-record state-machine replay.
            snap, delta = ckpt
            merged = dict(snap)
            for key, rec in delta.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
                if rec is None:
                    merged.pop(key, None)
                else:
                    merged[key] = rec
            func_records = {k: v for k, v in merged.items()  # simlint: ok(dict-iteration): snapshot+delta order is deterministic
                            if k.startswith("function/")}
            shardmap: Dict[str, object] = {}
            if self.rebalance_enabled or self.fn_split_enabled:
                shardmap = {k: v for k, v in merged.items()  # simlint: ok(dict-iteration): snapshot+delta order is deterministic
                            if k.startswith("shardmap/")}
            worker_records = {k: v for k, v in merged.items()  # simlint: ok(dict-iteration): snapshot+delta order is deterministic
                              if k.startswith("worker/")}
            delta_keys = set(delta)
        else:
            func_records = yield from self.store.read_prefix("function/")
            shardmap = {}
            if self.rebalance_enabled or self.fn_split_enabled:
                shardmap = yield from self.store.read_prefix("shardmap/")
            worker_records = yield from self.store.read_prefix("worker/")
            delta_keys = None
        self.functions = {}
        self.fn_shard_table = {}
        self._split_fns = set()
        for shard in self.shards:
            shard.functions = {}
            shard.worker_last_hb = {}
        self.workers = {}
        self.placer = self._make_placer()
        # post-recovery: hold downscaling for one autoscaling window
        self.no_downscale_until = self.env.now + c.recovery_no_downscale
        if self.incremental_recovery and self.cp_shards > 1:
            yield from self._recover_incremental(func_records, shardmap,
                                                 worker_records, delta_keys)
        else:
            yield from self._recover_serial(func_records, shardmap,
                                            worker_records, delta_keys)

    def _replay_shardmap_override(self, key: str, rec) -> None:
        """Re-apply one persisted ``shardmap/<fn>`` override (an ``int`` sole
        owner or a comma-separated shard-set) to the freshly installed
        table. Malformed or out-of-range records are ignored — the hash
        default stands."""
        name = key.split("/", 1)[1]
        st = self.functions.get(name)
        if st is None:
            return
        try:
            text = rec.decode()
        except AttributeError:
            return
        if "," in text:
            # shard-set override: the function was split — rebuild the
            # slices (empty; sandboxes are adopted as the workers push them
            # back) so failover keeps the split
            try:
                ids = tuple(int(x) for x in text.split(","))
            except ValueError:
                return
            if (len(ids) < 2 or len(set(ids)) != len(ids)
                    or not all(0 <= k < self.cp_shards for k in ids)):
                return
            cur = self._fn_shard_id(name)
            self.shards[cur].functions.pop(name, None)
            st.slices = {k: FunctionSlice(shard_id=k) for k in ids}
            st.rr_cursor = 0
            st.targets_t = -1.0
            # slices replay with zero heat (real creations refill it);
            # without the cooldown the first rebalance tick would merge the
            # split right back — failover must KEEP splits, with the same
            # hysteresis a fresh split gets
            st.split_cooldown_until = self.env.now + self.fn_split_cooldown
            for k in ids:
                self.shards[k].functions[name] = st
            self.fn_shard_table[name] = ids
            self._split_fns.add(name)
            return
        try:
            dst = int(text)
        except ValueError:
            return
        if not 0 <= dst < self.cp_shards:
            return
        cur = self._fn_shard_id(name)
        if dst != cur:
            self.shards[cur].functions.pop(name, None)
            self.shards[dst].functions[name] = st
        self.fn_shard_table[name] = dst

    def _install_recovered_worker(self, info: WorkerNodeInfo) -> None:
        self.workers[info.worker_id] = info
        self._worker_shard(info.worker_id).worker_last_hb[info.worker_id] \
            = self.env.now
        self.placer.add_node(info.worker_id, info.cpu_capacity_millis,
                             info.mem_capacity_mb)

    def _recover_worker_replay_cost(self, n_workers: int,
                                    n_delta: int, from_ckpt: bool) -> float:
        """Worker-record rebuild cost. Worker records dominate the replay at
        scale (100k workers vs hundreds of functions), so they are the slice
        the checkpoint accelerates: snapshot-sourced records bulk-load at
        ``cp_snapshot_load_per_record`` (deserialize into the maps), only
        post-checkpoint delta records pay the full per-record
        ``cp_cross_shard_op`` state-machine step."""
        c = self.costs
        if not from_ckpt:
            return c.cp_cross_shard_op * n_workers
        return (c.cp_cross_shard_op * n_delta
                + c.cp_snapshot_load_per_record * (n_workers - n_delta))

    def _recover_serial(self, func_records, shardmap,
                        worker_records, delta_keys=None) -> Generator:
        """Single-pass replay: everything rebuilt, then every shard admitted
        at once (the pre-incremental shape, with the replay now costed)."""
        c = self.costs
        if delta_keys is None:
            # legacy full-prefix replay: the exact expression the recovery
            # event-budget pin was recorded against (same float arithmetic)
            n_replay = len(func_records) + len(shardmap) + len(worker_records)
            if n_replay:
                yield self.env.timeout(c.cp_cross_shard_op * n_replay)
        else:
            n_wrk_delta = sum(1 for k in worker_records if k in delta_keys)
            dt = (c.cp_cross_shard_op * (len(func_records) + len(shardmap))
                  + self._recover_worker_replay_cost(len(worker_records),
                                                     n_wrk_delta, True))
            if dt:
                yield self.env.timeout(dt)
        for key, rec in func_records.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            self.install_function(Function.from_record(rec))
        for key, rec in shardmap.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            self._replay_shardmap_override(key, rec)
        for key, rec in worker_records.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            self._install_recovered_worker(WorkerNodeInfo.from_record(rec))
        # sync DP caches with the function list
        yield self.env.timeout(c.cp_recovery_dp_sync)
        names = list(self.functions.keys())  # simlint: ok(dict-iteration): install order is deterministic
        for dp in self.cluster.data_planes_alive():
            dp.sync_functions(names)
        self.start_leader()
        self.collector.event(self.env.now, "cp-recovered", self.cp_id)
        # async: workers push their sandbox lists; merge as they arrive
        for wid in list(self.workers.keys()):  # simlint: ok(dict-iteration): registration order is deterministic
            self.env.process(self._merge_worker_sandboxes(wid),
                             name=f"merge-{wid}")

    def _recover_incremental(self, func_records, shardmap,
                             worker_records, delta_keys=None) -> Generator:
        """Per-shard recovery units over one bounded snapshot.

        The snapshot is bucketed by *post-override* owner up front (pure
        arithmetic; the per-record cost is charged inside each unit), so a
        unit replays exactly its own slice: its functions (overrides
        included), then — after the cross-unit function barrier — its
        workers, then admission. Leadership is taken immediately: creations
        the units trigger must pass the leadership checks, while urgent
        metric pushes for a still-recovering shard are deferred
        (``receive_metric``) until that shard is admitted."""
        # resolve final ownership before spawning units: an override's
        # destination unit must install the function, or a unit racing the
        # override replay could install then lose it mid-flight
        home_of: Dict[str, object] = {}
        fn_objs: List[Function] = []
        for key, rec in func_records.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            fn = Function.from_record(rec)
            fn_objs.append(fn)
            home_of[fn.name] = self._default_shard_id(fn.name)
        overrides_by_fn: Dict[str, object] = {}
        for key, rec in shardmap.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            name = key.split("/", 1)[1]
            if name not in home_of:
                continue
            parsed = self._parse_shardmap_override(rec)
            if parsed is None:
                continue
            if type(parsed) is int:
                if not 0 <= parsed < self.cp_shards:
                    continue
            elif not all(0 <= k < self.cp_shards for k in parsed):
                continue
            overrides_by_fn[name] = parsed
            home_of[name] = parsed if type(parsed) is int else parsed[0]
        fns_by_shard: List[List[Function]] = [[] for _ in self.shards]
        for fn in fn_objs:
            h = home_of[fn.name]
            fns_by_shard[h if type(h) is int else h[0]].append(fn)
        workers_by_shard: List[List[WorkerNodeInfo]] = [[] for _ in self.shards]
        for key, rec in worker_records.items():  # simlint: ok(dict-iteration): WAL write order is deterministic
            info = WorkerNodeInfo.from_record(rec)
            workers_by_shard[info.worker_id % self.cp_shards].append(info)
        self.is_leader = True
        self._loops = []
        self._recovering_shards = set(range(self.cp_shards))
        barrier_state = {"pending": self.cp_shards}
        barrier = self.env.event()
        # stop() releases the barrier: a leader deposed mid-replay has its
        # units killed, and the elector's thread (blocked below) must not
        # hang forever on a barrier no unit will ever complete
        self._recovery_barrier = barrier
        for shard in self.shards:
            self._loops.append(self.env.process(
                self._recover_shard_unit(
                    shard, fns_by_shard[shard.shard_id], overrides_by_fn,
                    workers_by_shard[shard.shard_id], barrier_state, barrier,
                    delta_keys),
                name=f"cp{self.cp_id}-recover-{shard.shard_id}"))
        # the leader's own thread waits for the function table to be whole,
        # then syncs the DP caches; worker replay + admission continue in
        # the units behind it
        yield barrier
        self._recovery_barrier = None
        if not (self.alive and self.is_leader):
            return      # deposed mid-replay: stop() released the barrier
        yield self.env.timeout(self.costs.cp_recovery_dp_sync)
        names = list(self.functions.keys())  # simlint: ok(dict-iteration): unit replay order is deterministic
        for dp in self.cluster.data_planes_alive():
            dp.sync_functions(names)

    @staticmethod
    def _parse_shardmap_override(rec):
        """Validated override payload: an ``int`` destination, a tuple
        shard-set, or ``None`` for a malformed record. Mirrors
        ``_replay_shardmap_override``'s acceptance rules (range checks need
        ``cp_shards`` and happen at apply time)."""
        try:
            text = rec.decode()
        except AttributeError:
            return None
        if "," in text:
            try:
                ids = tuple(int(x) for x in text.split(","))
            except ValueError:
                return None
            if len(ids) < 2 or len(set(ids)) != len(ids):
                return None
            return ids
        try:
            return int(text)
        except ValueError:
            return None

    def _recover_shard_unit(self, shard: ControlPlaneShard,
                            fns: List[Function], overrides_by_fn: Dict,
                            workers: List[WorkerNodeInfo],
                            barrier_state: Dict, barrier,
                            delta_keys=None) -> Generator:
        """One shard's recovery unit: replay functions homed here (overrides
        included), wait for every other unit's function replay, replay this
        shard's workers, then admit the shard."""
        c = self.costs
        n_fn_work = len(fns) + sum(1 for fn in fns
                                   if fn.name in overrides_by_fn)
        if n_fn_work:
            yield self.env.timeout(c.cp_cross_shard_op * n_fn_work)
        for fn in fns:
            st = FunctionState(function=fn,
                               autoscaler=FunctionAutoscalerState(
                                   fn.scaling,
                                   vectorized=self.vector_windows))
            self.functions[fn.name] = st
            # overrides_by_fn entries were range-validated at bucketing time
            ov = overrides_by_fn.get(fn.name)
            if ov is not None and type(ov) is not int:
                st.slices = {k: FunctionSlice(shard_id=k) for k in ov}
                st.rr_cursor = 0
                st.targets_t = -1.0
                st.split_cooldown_until = (self.env.now
                                           + self.fn_split_cooldown)
                for k in ov:
                    self.shards[k].functions[fn.name] = st
                self.fn_shard_table[fn.name] = ov
                self._split_fns.add(fn.name)
                continue
            dst = ov if ov is not None else self._default_shard_id(fn.name)
            self.fn_shard_table[fn.name] = dst
            self.shards[dst].functions[fn.name] = st
        # barrier: worker merges (pushed sandbox lists) anywhere must see a
        # complete function table, or recovered replicas of a function homed
        # on a slower shard would be silently skipped and re-created
        barrier_state["pending"] -= 1
        if barrier_state["pending"] == 0:
            barrier.succeed(None)
        else:
            yield barrier
        if workers:
            if delta_keys is None:
                yield self.env.timeout(c.cp_cross_shard_op * len(workers))
            else:
                n_delta = sum(1 for info in workers
                              if f"worker/{info.worker_id}" in delta_keys)
                dt = self._recover_worker_replay_cost(len(workers),
                                                      n_delta, True)
                if dt:
                    yield self.env.timeout(dt)
        for info in workers:
            self._install_recovered_worker(info)
        # admit this shard: health + autoscale loops from here on
        self._start_shard_loops(shard)
        self._recovering_shards.discard(shard.shard_id)
        self.collector.event(self.env.now, "cp-shard-recovered",
                             (self.cp_id, shard.shard_id))
        for info in workers:
            self.env.process(self._merge_worker_sandboxes(info.worker_id),
                             name=f"merge-{info.worker_id}")
        if not self._recovering_shards:
            self._start_global_loops()
            self.collector.event(self.env.now, "cp-recovered", self.cp_id)

    def _merge_worker_sandboxes(self, wid: int) -> Generator:
        yield self.env.timeout(self.costs.grpc_call)
        worker = self.cluster.worker_by_id(wid)
        if worker is None or not worker.daemon_alive:
            return
        for sb in worker.list_sandboxes():
            st = self.functions.get(sb.function_name)
            if st is None:
                continue
            st.sandboxes[sb.sandbox_id] = sb
            if st.slices is not None:
                # replayed shard-set override: attach the recovered replica
                # to its subshard so per-slice accounting is coherent
                self._adopt_sandbox(st, sb)
            self.placer.commit(wid, st.function.scaling.cpu_req_millis,
                               st.function.scaling.mem_req_mb)
            self._queue_endpoint_update("add", sb.function_name, sb)
