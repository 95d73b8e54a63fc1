"""Dirigent cluster wiring: CP replicas + DP replicas + workers + front-end LB.

``Cluster`` is the top-level façade used by benchmarks, tests and examples:

    cluster = Cluster(env, n_workers=93, runtime="firecracker")
    cluster.start()
    env.run_until_event(cluster.register(Function(...)))
    cluster.invoke("fn", exec_time=0.01)
    env.run(until=300)
    cluster.collector.summary()

Failure injection: ``fail_control_plane_leader()``, ``fail_data_plane(i)``,
``fail_worker_daemon(wid)``, ``fail_worker_node(wid)`` — each with the
corresponding recovery path from paper §3.4.

Scaling knobs: ``cp_shards`` partitions the control plane itself into N
internal shards (per-shard scale lock, autoscale loop, health monitor and
endpoint-flush queue — see core/control_plane.py); the default of 1
reproduces the paper's single-lock CP bit-identically. ``placement_policy``
selects node scoring (core/policies.py); with ``cp_shards > 1`` the CP
always composes a ``PartitionedPlacer`` whose partitions align with the CP
shards so placements stay shard-local on the hot path.

Load-adaptive sharding knobs (``cp_rebalance_*``): with
``cp_rebalance_enabled=True`` the leader CP runs a periodic rebalancer that
migrates hot functions off the hottest shard via an explicit handoff,
keeping a skewed (Zipf-popularity) function mix from convoying on one scale
lock; ``cp_rebalance_period`` / ``cp_rebalance_hot_factor`` /
``cp_rebalance_max_moves`` override the ``DirigentCosts`` defaults. The
default (off) keeps the static hash partition bit-identically.

Per-function creation sharding (``cp_fn_split_*``): with
``cp_fn_split_enabled=True`` the rebalancer escalates past whole-function
moves — a single function whose creation load dominates its shard (a load no
move can fix) is *split* across a shard-set, every subshard creating for it
under its own scale lock on its own worker partition, and merged back when
its heat decays (``cp_fn_split_max_shards`` / ``cp_fn_split_min_load`` /
``cp_fn_split_cooldown`` override the ``DirigentCosts`` defaults). Operator
guidance for all of these lives in docs/operations.md.

Multi-data-plane serving (``dp_spread_*`` / ``dp_conn_reuse``): the DP-side
twin of the CP scale-out above. With ``dp_spread_enabled=True`` the front
end generalizes its ``stable_hash(fn) % n_dps`` steering to a **fn→DP-set**
table (the fn→shard-set pattern one layer down): a function whose arrival
rate crosses ``dp_spread_min_rate`` is spread round-robin across
``dp_spread_width`` consecutive rotation members (home DP first), dividing
its connection load — and therefore the paper's C5 per-DP ephemeral-port
ceiling — across the set, while cold functions stay sticky to one DP and
keep centralized in-flight accounting. ``dp_conn_reuse`` adds a keep-alive
connection pool on the DP invoke path (port per connection, not per
request). Both default off; the sticky one-connection-per-request front end
stays bit-identical.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, Generator, List, Optional

from repro_torch.core.abstractions import DataPlaneInfo, Function, WorkerNodeInfo
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.costmodel import CostModel, DEFAULT_COSTS
from repro_torch.core.data_plane import DataPlane
from repro_torch.core.leader_election import LeaderElector
from repro_torch.core.metrics import Collector
from repro_torch.core.persistence import SimStore
from repro_torch.core.request import Invocation, InvocationMode
from repro_torch.core.worker import WorkerDaemon
from repro_torch.simcore import Environment, Event, Interrupt, grid_ceil, stable_hash


def fn_dp_set(fn: str, backends: List[int], width: int) -> tuple:
    """The DP-set for a spread function: ``width`` consecutive members of the
    LB rotation starting at the function's home slot (``stable_hash(fn) %
    len(backends)``), home first. Pure and process-independent — any front
    end (or test) computes the same set from the same rotation, exactly like
    the CP's fn→shard-set. Width is clamped to the rotation size; width 1
    degrades to the sole-DP sticky pick."""
    n = len(backends)
    width = max(1, min(width, n))
    home = stable_hash(fn) % n
    return tuple(backends[(home + i) % n] for i in range(width))


class _HeartbeatWheel:
    """Per-CP-shard worker-heartbeat aggregator.

    The paper's C9 load side-effect (every worker beat touches the owning CP
    shard's shared structures) used to be modeled with one generator process
    per worker, each beat spawning a sub-process to acquire the shard lock —
    ~5 heap events per beat, O(n_workers) event tax at 5000 workers. The
    wheel replaces all of a shard's per-worker processes with one process and
    a deadline heap: each worker's beat instants are *identical* (same
    ``hb-{wid}`` RNG phase draw, same accumulated ``+= period`` float chain),
    beats due at the same instant run in worker-id order, and the lock touch
    itself goes through ``Resource.reserve`` — zero events unless a creation
    actually collides with the beat (see control_plane.heartbeat).
    """

    __slots__ = ("heap", "proc", "sleep_until")

    def __init__(self):
        self.heap: List[tuple] = []     # (beat deadline, wid)
        self.proc = None                # the wheel's driver Process
        self.sleep_until: Optional[float] = None


class Cluster:
    def __init__(self, env: Environment, n_workers: int = 93,
                 n_data_planes: int = 3, n_control_planes: int = 3,
                 runtime: str = "firecracker",
                 costs: Optional[CostModel] = None,
                 persist_sandbox_state: bool = False,
                 enable_ha_sim: bool = False,
                 sandbox_concurrency: int = 1,
                 hedge_after: Optional[float] = None,
                 lb_policy: str = "least_loaded",
                 placement_policy: str = "balanced",
                 cp_shards: int = 1,
                 cp_rebalance_enabled: bool = False,
                 cp_rebalance_period: Optional[float] = None,
                 cp_rebalance_hot_factor: Optional[float] = None,
                 cp_rebalance_max_moves: Optional[int] = None,
                 cp_fn_split_enabled: bool = False,
                 cp_fn_split_max_shards: Optional[int] = None,
                 cp_fn_split_min_load: Optional[float] = None,
                 cp_fn_split_cooldown: Optional[float] = None,
                 cp_ep_flush_coalesce: Optional[bool] = None,
                 dp_spread_enabled: bool = False,
                 dp_spread_width: Optional[int] = None,
                 dp_spread_min_rate: Optional[float] = None,
                 dp_conn_reuse: Optional[bool] = None,
                 dp_conn_idle_timeout: Optional[float] = None,
                 cp_incremental_recovery: bool = True,
                 cp_vector_windows: bool = False,
                 cp_batched_eviction: bool = True,
                 hb_cohort_quantum: Optional[float] = None,
                 persist_group_commit: Optional[bool] = None,
                 persist_read_per_record: Optional[float] = None,
                 cp_checkpoint_enabled: bool = False,
                 cp_checkpoint_period: Optional[float] = None,
                 create_hook: Optional[Callable] = None,
                 teardown_hook: Optional[Callable] = None,
                 live_backend: Optional[object] = None):
        self.env = env
        # live execution mode (repro_torch.live.LiveBackend): the backend supplies
        # the worker hooks and the invoke-path admit/collect unless explicit
        # hooks override it; None (default) keeps the DES path bit-identical
        self.live_backend = live_backend
        if live_backend is not None:
            create_hook = create_hook or live_backend.create_hook
            teardown_hook = teardown_hook or live_backend.teardown_hook
        self.costs = (costs or DEFAULT_COSTS).dirigent
        self.collector = Collector()
        self._persist_group_commit = (
            self.costs.persist_group_commit if persist_group_commit is None
            else persist_group_commit)
        self.store = SimStore(
            env, fsync_latency=self.costs.persist_write,
            replication_latency=self.costs.persist_replication,
            read_latency=self.costs.persist_read,
            n_replicas=n_control_planes,
            fsync_sigma=self.costs.persist_write_sigma,
            stall_prob=self.costs.persist_stall_prob,
            stall=self.costs.persist_stall,
            group_commit=self._persist_group_commit,
            max_batch=self.costs.persist_max_batch,
            read_per_record=(
                self.costs.persist_read_per_record
                if persist_read_per_record is None
                else persist_read_per_record),
            snapshot_load_per_record=self.costs.cp_snapshot_load_per_record,
            checkpoint_enabled=cp_checkpoint_enabled)
        # Sandbox ids are allocated from one cluster-wide counter shared by
        # every CP replica: a freshly elected leader must not reissue ids the
        # deposed leader already handed to workers, or its new sandboxes would
        # silently shadow adopted ones in ``worker.sandboxes``.
        self._sandbox_ids = itertools.count(1)
        self.control_planes: List[ControlPlane] = [
            ControlPlane(env, i, self.costs, self, self.store, self.collector,
                         persist_sandbox_state=persist_sandbox_state,
                         placement_policy=placement_policy,
                         cp_shards=cp_shards,
                         rebalance_enabled=cp_rebalance_enabled,
                         rebalance_period=cp_rebalance_period,
                         rebalance_hot_factor=cp_rebalance_hot_factor,
                         rebalance_max_moves=cp_rebalance_max_moves,
                         fn_split_enabled=cp_fn_split_enabled,
                         fn_split_max_shards=cp_fn_split_max_shards,
                         fn_split_min_load=cp_fn_split_min_load,
                         fn_split_cooldown=cp_fn_split_cooldown,
                         ep_flush_coalesce=cp_ep_flush_coalesce,
                         incremental_recovery=cp_incremental_recovery,
                         vector_windows=cp_vector_windows,
                         batched_eviction=cp_batched_eviction,
                         checkpoint_enabled=cp_checkpoint_enabled,
                         checkpoint_period=cp_checkpoint_period)
            for i in range(n_control_planes)
        ]
        self.data_planes: List[DataPlane] = [
            DataPlane(env, i, self.costs, self, self.collector,
                      concurrency=sandbox_concurrency,
                      hedge_after=hedge_after, lb_policy=lb_policy,
                      conn_reuse=dp_conn_reuse,
                      conn_idle_timeout=dp_conn_idle_timeout)
            for i in range(n_data_planes)
        ]
        self.workers: Dict[int, WorkerDaemon] = {}
        for wid in range(n_workers):
            # three-octet address plan: the old (10, 0, wid // 250, wid % 250)
            # overflowed an octet at 64k workers — the 100k cells need the
            # full 10.0.0.0/8 space
            info = WorkerNodeInfo(
                worker_id=wid, name=f"w{wid}",
                ip=(10, (wid >> 16) & 255, (wid >> 8) & 255, wid & 255),
                port=9000)
            self.workers[wid] = WorkerDaemon(env, info, self.costs,
                                             runtime=runtime,
                                             create_hook=create_hook,
                                             teardown_hook=teardown_hook,
                                             live_backend=live_backend)
        self.elector = LeaderElector(env, self, self.costs,
                                     enable_hb_sim=enable_ha_sim)
        self.enable_ha_sim = enable_ha_sim
        self._inv_ids = itertools.count(1)
        # one heartbeat wheel per CP shard (the same wid % cp_shards
        # partition the CP health monitors use)
        self._cp_shards = max(1, cp_shards)
        self._hb_wheels = [_HeartbeatWheel() for _ in range(self._cp_shards)]
        # cohort mode: beat deadlines rounded UP onto a shared grid, whole
        # same-deadline cohorts delivered per heap event (heartbeat_batch).
        # None (default) keeps per-worker exact deadlines bit-identically;
        # the quantum must be a power-of-two fraction of the heartbeat
        # period so ``t + period`` stays on-grid exactly (see grid_ceil)
        self._hb_cohort_quantum = hb_cohort_quantum
        if hb_cohort_quantum is not None:
            ratio = self.costs.worker_heartbeat_period / hb_cohort_quantum
            assert ratio == int(ratio), (
                "hb_cohort_quantum must divide worker_heartbeat_period "
                "exactly, or cohorts drift off-grid after one beat")
        self._started = False
        # front-end LB rotation: dead DPs keep receiving traffic until the
        # keepalived health check removes them (paper §5.4 DP failover)
        self._lb_backends = [dp.dp_id for dp in self.data_planes]
        # fn→DP-set steering (multi-DP serving; off by default). The table
        # maps a hot function to its DP-set tuple (home first); functions
        # absent from the table take the sticky hash pick unchanged.
        c = self.costs
        self._dp_spread_enabled = dp_spread_enabled
        self._dp_spread_width = (c.dp_spread_width if dp_spread_width is None
                                 else dp_spread_width)
        self._dp_spread_min_rate = (
            c.dp_spread_min_rate if dp_spread_min_rate is None
            else dp_spread_min_rate)
        self.fn_dp_table: Dict[str, tuple] = {}
        self._dp_rr: Dict[str, int] = {}        # per-fn round-robin cursor
        self._fe_counts: Dict[str, int] = {}    # arrivals this window
        self._fe_window_start = env.now
        self._dp_last_over: Dict[str, float] = {}   # last instant over rate

    # -- topology ------------------------------------------------------------------
    def control_planes_alive(self) -> List[ControlPlane]:
        return [cp for cp in self.control_planes if cp.alive]

    def control_plane_by_id(self, cp_id: Optional[int]) -> Optional[ControlPlane]:
        if cp_id is None:
            return None
        cp = self.control_planes[cp_id]
        return cp if cp.alive else None

    def control_plane_leader(self) -> Optional[ControlPlane]:
        return self.control_plane_by_id(self.elector.leader_id)

    def data_planes_alive(self) -> List[DataPlane]:
        return [dp for dp in self.data_planes if dp.alive]

    def worker_by_id(self, wid: int) -> Optional[WorkerDaemon]:
        return self.workers.get(wid)

    # -- startup ------------------------------------------------------------------
    def start(self) -> None:
        """Elect a leader, register components, start heartbeats."""
        assert not self._started
        self._started = True
        self.elector.bootstrap()
        leader = self.control_plane_leader()
        done = self.env.event()

        def boot(env):
            for dp in self.data_planes:
                info = DataPlaneInfo(dp_id=dp.dp_id,
                                     ip=(10, 1, 0, dp.dp_id), port=8080)
                yield from leader.register_data_plane(info)
            if self._persist_group_commit:
                # bulk boot: the whole registration log lands through
                # write_many in O(batches) group commits instead of
                # O(n_workers) serialized fsyncs; every registration commits
                # at the same instant, so heartbeats (started afterwards, in
                # the same worker order and off the same hb-{wid} streams)
                # never race a still-draining boot log
                yield from leader.register_workers_bulk(
                    [w.info for w in self.workers.values()])
                for wid in self.workers:
                    self._hb_wheel_add(wid)
            else:
                for wid, w in self.workers.items():
                    yield from leader.register_worker(w.info)
                    # the daemon starts heartbeating the moment it registers.
                    # Starting these only after the WHOLE boot loop used to
                    # let early-registered workers exceed the heartbeat
                    # timeout while later registrations' persistence writes
                    # were still draining (boot is O(n_workers) fsyncs of sim
                    # time), silently evicting ~a quarter of a 1000-worker
                    # fleet before first beat.
                    self._hb_wheel_add(wid)
            done.succeed(None)

        self.env.process(boot(self.env), name="cluster-boot")
        self.env.run_until_event(done)

    # -- heartbeat wheel ------------------------------------------------------
    def _hb_wheel_add(self, wid: int) -> None:
        """Enroll a worker in its shard's heartbeat wheel, beating from now.

        The first beat lands at ``(now + phase) + period`` — the same float
        arithmetic, in the same order, as the retired per-worker generator
        (process start, ``timeout(phase)``, then ``timeout(period)`` per
        beat), with the phase drawn from the same ``hb-{wid}`` stream, so
        every beat instant is bit-identical to the per-process model."""
        c = self.costs
        phase = self.env.rng(f"hb-{wid}").uniform(0, c.worker_heartbeat_period)
        first = (self.env.now + phase) + c.worker_heartbeat_period
        if self._hb_cohort_quantum is not None:
            # cohort mode: the first beat snaps UP to the grid; every later
            # beat adds the (grid-multiple) period, so the worker stays in
            # its cohort forever. A beat moves at most one quantum later
            # than its exact instant — keep the quantum well under
            # ``worker_heartbeat_timeout - 2*period`` so quantization alone
            # can never push a live worker past the eviction deadline.
            first = grid_ceil(first, self._hb_cohort_quantum)
        wheel = self._hb_wheels[wid % self._cp_shards]
        heapq.heappush(wheel.heap, (first, wid))
        if wheel.proc is None or not wheel.proc.is_alive:
            wheel.proc = self.env.process(
                self._hb_wheel_run(wheel),
                name=f"hb-wheel-{wid % self._cp_shards}")
        elif wheel.sleep_until is not None and first < wheel.sleep_until:
            # the wheel is parked past the new worker's first beat: preempt
            wheel.proc.interrupt("earlier-deadline")

    def _hb_wheel_run(self, wheel: _HeartbeatWheel) -> Generator:
        env, heap = self.env, wheel.heap
        period = self.costs.worker_heartbeat_period
        cohorts = self._hb_cohort_quantum is not None
        while True:
            while heap and heap[0][0] <= env.now:
                if cohorts:
                    # cohort mode: drain EVERY beat sharing this quantized
                    # deadline in one go — heap pops with equal deadlines
                    # come out in worker-id order (tuple comparison), and
                    # the whole cohort becomes one heartbeat_batch call
                    # instead of n lock reserves on the same instant
                    t = heap[0][0]
                    live: List[int] = []
                    while heap and heap[0][0] == t:
                        _, wid = heapq.heappop(heap)
                        w = self.workers.get(wid)
                        if w is not None and w.daemon_alive:
                            live.append(wid)
                        heapq.heappush(heap, (t + period, wid))
                    if live:
                        cp = self.control_plane_leader()
                        if cp is not None:
                            cp.heartbeat_batch(live)
                    continue
                # due beats run in (deadline, worker-id) order — bit-identical
                # instants, deterministic tie order
                t, wid = heapq.heappop(heap)
                w = self.workers.get(wid)
                if w is not None and w.daemon_alive:
                    cp = self.control_plane_leader()
                    if cp is not None:
                        cp.heartbeat(wid)
                # next beat continues this worker's own float-add chain
                heapq.heappush(heap, (t + period, wid))
            wheel.sleep_until = heap[0][0]
            try:
                # absolute-deadline sleep: the beat must run at the heap
                # instant bit-exactly (now + (t - now) != t in float)
                yield env.timeout_at(wheel.sleep_until)
            except Interrupt:
                pass        # a newly added worker beats earlier: re-aim
            wheel.sleep_until = None

    # -- user API -------------------------------------------------------------------
    def register(self, fn: Function) -> Event:
        """Returns an event that fires when registration completes."""
        leader = self.control_plane_leader()
        done = self.env.event()

        def reg(env):
            yield from leader.register_function(fn)
            done.succeed(fn.name)

        self.env.process(reg(self.env), name=f"register-{fn.name}")
        return done

    def register_sync(self, fn: Function) -> None:
        self.env.run_until_event(self.register(fn))

    def invoke(self, function_name: str, exec_time: float,
               mode: InvocationMode = InvocationMode.SYNC,
               payload: Optional[Callable] = None,
               request: Optional[object] = None) -> Invocation:
        """Submit an invocation at env.now; returns the Invocation record.
        ``request`` (a ``LiveRequest``) rides the invocation to whatever
        sandbox the DP picks and is executed there by the live backend."""
        inv = Invocation(inv_id=next(self._inv_ids),
                         function_name=function_name,
                         arrival=self.env.now, exec_time=exec_time,
                         mode=mode, payload=payload, request=request)
        self.env.process(self._front_end(inv), name=f"inv-{inv.inv_id}")
        return inv

    # -- fn→DP-set steering (multi-DP serving) --------------------------------
    def spread_function(self, fn: str, width: Optional[int] = None) -> tuple:
        """Install (or re-derive) a DP-set for ``fn`` explicitly. Used by the
        auto-widener and by operators/tests pre-spreading a known-hot
        function before its first burst."""
        members = fn_dp_set(fn, self._lb_backends,
                            self._dp_spread_width if width is None else width)
        self.fn_dp_table[fn] = members
        self._dp_rr.setdefault(fn, 0)
        self._dp_last_over[fn] = self.env.now
        self.collector.event(self.env.now, "fn-dp-spread", (fn, members))
        return members

    def _note_arrival(self, fn: str) -> None:
        """Count front-end arrivals per window; widen a function's DP-set the
        moment it crosses the spread threshold mid-window (waiting for the
        window edge would eat a full burst on one DP's port pool)."""
        c = self.costs
        now = self.env.now
        if now - self._fe_window_start >= c.dp_spread_window:
            self._roll_spread_window(now)
        n = self._fe_counts.get(fn, 0) + 1
        self._fe_counts[fn] = n
        if (fn not in self.fn_dp_table and len(self._lb_backends) > 1
                and n >= self._dp_spread_min_rate * c.dp_spread_window):
            self.spread_function(fn)

    def _roll_spread_window(self, now: float) -> None:
        c = self.costs
        half = 0.5 * self._dp_spread_min_rate * c.dp_spread_window
        for fn, cnt in self._fe_counts.items():
            if fn in self.fn_dp_table and cnt >= half:
                self._dp_last_over[fn] = now
        stale = [fn for fn, members in self.fn_dp_table.items()
                 if len(members) > 1
                 and now - self._dp_last_over.get(fn, now) >= c.dp_spread_cooldown]
        for fn in stale:
            # cooled off: fold back to the sticky sole-DP path
            del self.fn_dp_table[fn]
            self._dp_rr.pop(fn, None)
            self._dp_last_over.pop(fn, None)
            self.collector.event(now, "fn-dp-narrow", fn)
        self._fe_counts.clear()
        self._fe_window_start = now

    def _steer(self, fn: str) -> "DataPlane":
        """Pick the DP for one invocation. Default path: the sticky hash pick,
        arithmetic-identical to the pre-spread front end. Spread path: round-
        robin over the function's DP-set, skipping members evicted from the
        rotation (a *dead* member still in rotation is returned as-is — the
        caller models the connection-refused window, same as sticky)."""
        if self._dp_spread_enabled:
            self._note_arrival(fn)
            members = self.fn_dp_table.get(fn)
            if members is not None:
                live = [d for d in members if d in self._lb_backends]
                if live:
                    cur = self._dp_rr.get(fn, 0)
                    self._dp_rr[fn] = cur + 1
                    return self.data_planes[live[cur % len(live)]]
        idx = stable_hash(fn) % len(self._lb_backends)
        return self.data_planes[self._lb_backends[idx]]

    def _front_end(self, inv: Invocation) -> Generator:
        """HAProxy front-end: function-hash steering across the LB rotation
        (which may briefly include a crashed DP until keepalived reacts).
        With ``dp_spread_enabled``, hot functions steer via the fn→DP-set
        table instead (see ``_steer``)."""
        yield self.env.timeout(self.costs.lb_hop)
        if not self._lb_backends:
            inv.failed = True
            inv.failure_reason = "no data plane"
            inv.t_done = self.env.now
            self.collector.done(inv)
            return
        dp = self._steer(inv.function_name)
        if not dp.alive:
            inv.failed = True
            inv.failure_reason = "connection refused (dead DP in rotation)"
            inv.t_done = self.env.now
            self.collector.done(inv)
            return
        if inv.mode == InvocationMode.ASYNC:
            # async: persist to the durable queue, ack client, deliver with
            # at-least-once retry (paper §3.4.2)
            yield from self.store.write(f"asyncq/{inv.inv_id}", b"1")
            self.env.process(self._async_deliver(inv, dp),
                             name=f"async-{inv.inv_id}")
            return
        yield from dp.handle(inv)

    def _async_deliver(self, inv: Invocation, dp: DataPlane,
                       timeout: float = 60.0, max_retries: int = 3) -> Generator:
        for attempt in range(max_retries + 1):
            inv.retries = attempt
            done = self.env.event()

            def run(env, inv=inv, dp=dp, done=done):
                yield from dp.handle(inv)
                if not done.triggered:
                    done.succeed("ok")

            self.env.process(run(self.env), name=f"async-try-{inv.inv_id}")
            idx, _ = yield self.env.any_of([done, self.env.timeout(timeout)])
            if idx == 0 and not inv.failed:
                break
            # retry: reset failure state, re-deliver (at-least-once)
            alive = self.data_planes_alive()
            if not alive:
                break
            dp = alive[stable_hash(inv.function_name) % len(alive)]
            inv.failed = False
        yield from self.store.write(f"asyncq/{inv.inv_id}", None)

    # -- failure injection (paper §5.4) ----------------------------------------------
    def fail_control_plane_leader(self) -> None:
        leader = self.control_plane_leader()
        if leader:
            leader.stop()
            self.collector.event(self.env.now, "cp-failed", leader.cp_id)

    def fail_data_plane(self, dp_id: int) -> None:
        dp = self.data_planes[dp_id]
        dp.fail()
        self.collector.event(self.env.now, "dp-failed", dp_id)

        def lb_evict(env):
            # keepalived health-check detection, then rotation update
            yield env.timeout(self.costs.lb_health_check)
            if dp_id in self._lb_backends:
                self._lb_backends.remove(dp_id)
        self.env.process(lb_evict(self.env), name=f"lb-evict-{dp_id}")
        self.env.process(self._recover_data_plane(dp_id), name=f"dp-recover-{dp_id}")

    def _recover_data_plane(self, dp_id: int) -> Generator:
        """systemd restart -> re-register with CP -> pull caches -> LB reload."""
        c = self.costs
        yield self.env.timeout(c.systemd_restart_delay)
        yield self.env.timeout(c.dp_resync_cost)
        dp = self.data_planes[dp_id]
        leader = self.control_plane_leader()
        functions, endpoints = [], {}
        if leader is not None:
            # both snapshots iterate insertion-ordered dicts whose writes
            # (install_function / sandbox adoption) happen in deterministic
            # event order, so the recovered DP tables replay byte-identically
            # (regression: test_fault_tolerance.py::test_dp_recovery_snapshot_order)
            functions = list(leader.functions.keys())  # simlint: ok(dict-iteration): install order is deterministic
            endpoints = {fn: [s for s in st.sandboxes.values()]  # simlint: ok(dict-iteration): creation order is deterministic
                         for fn, st in leader.functions.items()}  # simlint: ok(dict-iteration): install order is deterministic
        dp.recover(functions, endpoints)
        yield self.env.timeout(c.lb_reconfigure)
        if dp_id not in self._lb_backends:
            self._lb_backends.append(dp_id)
            self._lb_backends.sort()
        self.collector.event(self.env.now, "dp-recovered", dp_id)

    def fail_worker_daemon(self, wid: int) -> None:
        self.workers[wid].fail_daemon()
        self.collector.event(self.env.now, "worker-daemon-failed", wid)

    def recover_worker_daemon(self, wid: int) -> None:
        self.workers[wid].recover_daemon()
        leader = self.control_plane_leader()
        if leader:
            leader.restore_worker(wid)
        self.collector.event(self.env.now, "worker-daemon-recovered", wid)

    def fail_worker_node(self, wid: int) -> None:
        self.workers[wid].fail_node()
        self.collector.event(self.env.now, "worker-node-failed", wid)
