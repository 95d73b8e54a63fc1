"""Monolithic data plane (paper §3.2, §3.3).

One process-level component owning, for every function steered to it:

  * the per-function request queue (requests waiting for a sandbox — this is
    what replaces Knative's per-sandbox queue-proxy sidecars);
  * the endpoint list (ready sandboxes) with per-sandbox concurrency slots
    (throttling, default 1 request at a time);
  * least-loaded load balancing across endpoints (Knative default policy);
  * autoscaling metric reports to the control plane (periodic + an immediate
    push when a queue forms with zero capacity — a cold start).

The front-end LB steers invocations by function-ID hash, so all invocations
of a function land on one DP replica and in-flight accounting is centralized.

Endpoint updates arrive from the control plane per *CP shard* flush queue —
and, for a function split across a CP shard-set (``cp_fn_split_enabled``),
from **multiple owning subshards concurrently**: each subshard broadcasts
exactly the adds/removes for the replicas it created or tore down, exactly
once, so a function's endpoint table here is the union of its subshards'
flushes. Nothing in the DP keys on the sending shard — endpoints are keyed
by sandbox id, adds are idempotent, removes of unknown ids are no-ops — so
the DP is oblivious to splits and merges by construction (the CP's merge
handoff moves still-pending flush entries between queues rather than
re-sending them, preserving exactly-once; tests/test_fn_split.py pins it).

Mechanism → paper section map (claim ids C1..C12 as in costmodel.py):

  * ``handle`` / ``_dispatch`` — §3.3 warm path: LB hop → DP proxy CPU
    (``dp_proxy_cpu`` on ``dp_cores``) → ephemeral port from the
    ``dp_port_pool`` → worker NAT hop. Port exhaustion under sustained load
    is what caps the warm path at ~4000/s (C5, Fig 8).
  * ``_metrics_loop`` / urgent push — §3.2 autoscaling inputs: in-flight
    counts batched to the CP every ``metrics_report_period`` (250 ms), plus
    an *event-driven* push the instant a queue forms with zero free slots
    (the cold-start trigger; keeps scale-up off the periodic tick).
  * dead-endpoint report (``report_dead_sandbox``) — §3.4 stale-state
    self-healing: a dispatch to a sandbox that died behind the CP's back
    fails once, evicts the endpoint locally and reconciles via the CP —
    never an endless failure stream.
  * ``recover`` — §5.4 DP failover (C11): systemd restart → re-register →
    pull function/endpoint caches from the CP (~2 s end to end vs ~15 s for
    the Istio-gateway-bound baseline).
  * request hedging (``hedge_after``) — §4 pluggable-policy surface, off by
    default for paper fidelity (policies.py holds the LB policies).
  * connection reuse (``conn_reuse``) — a per-endpoint keep-alive pool on
    the invoke path: a port is acquired once per *connection* and reused
    across requests instead of burning a ``dp_port_hold`` TIME_WAIT per
    request. Close semantics follow TCP's asymmetry: an idle-timeout close
    is DP-initiated, so the DP's port rides TIME_WAIT before freeing; an
    endpoint-teardown close is server-initiated (the DP is the passive
    closer), so the port frees immediately. Off by default — the paper's
    one-connection-per-request path stays bit-identical.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Generator, List, Optional, TYPE_CHECKING

from repro_torch.core.abstractions import Sandbox
from repro_torch.core.costmodel import DirigentCosts
from repro_torch.core.metrics import Collector
from repro_torch.core.request import Invocation
from repro_torch.simcore import Environment, Event

if TYPE_CHECKING:
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.cluster import Cluster


@dataclass
class Endpoint:
    sandbox: Sandbox
    capacity: int = 1           # concurrency throttle (paper: 1 req at a time)
    in_use: int = 0
    draining: bool = False

    @property
    def free(self) -> int:
        return 0 if self.draining else self.capacity - self.in_use


@dataclass
class FunctionTable:
    endpoints: Dict[int, Endpoint] = field(default_factory=dict)
    queue: Deque[Invocation] = field(default_factory=deque)
    inflight: int = 0           # executing + queued (the autoscaling signal)
    creating_hint: int = 0      # CP-echoed count (metric freshness only)
    free_slots: int = 0         # incrementally maintained sum of non-draining
    #                             endpoints' free capacity: the O(1) stand-in
    #                             for the per-queued-request any-free-slot
    #                             scan (every in_use/draining transition in
    #                             DataPlane adjusts it; the runtime sanitizer
    #                             cross-checks it against the scan)


class _Conn:
    """One keep-alive connection DP→endpoint. Pins the *pool object* its
    port was acquired from: a DP crash rebuilds the port table (fresh
    ``Resource``), and any straggler release from the old life must settle
    against the old pool, never leak into the recovered one."""

    __slots__ = ("sandbox_id", "pool", "idle_since", "closed")

    def __init__(self, sandbox_id: int, pool):
        self.sandbox_id = sandbox_id
        self.pool = pool
        self.idle_since = -1.0      # -1 while checked out
        self.closed = False


class DataPlane:
    def __init__(self, env: Environment, dp_id: int, costs: DirigentCosts,
                 cluster: "Cluster", collector: Collector,
                 concurrency: int = 1, hedge_after: Optional[float] = None,
                 lb_policy: str = "least_loaded",
                 conn_reuse: Optional[bool] = None,
                 conn_idle_timeout: Optional[float] = None):
        self.env = env
        self.dp_id = dp_id
        self.costs = costs
        self.cluster = cluster
        self.collector = collector
        self.concurrency = concurrency
        self.hedge_after = hedge_after   # straggler mitigation (None = off)
        self.hedged = 0
        self.hedge_wins = 0
        self.conn_reuse = (costs.dp_conn_reuse if conn_reuse is None
                           else conn_reuse)
        self.conn_idle_timeout = (
            costs.dp_conn_idle_timeout if conn_idle_timeout is None
            else conn_idle_timeout)
        # keep-alive pool: sandbox_id -> LIFO stack of parked _Conns (LIFO so
        # the warmest conn is reused and the cold tail idles out)
        self._idle_conns: Dict[int, List[_Conn]] = {}
        self.conn_open = 0          # live conns (checked out + parked)
        self.conn_hits = 0
        self.conn_misses = 0
        self.conn_expired = 0
        self.time_wait_ports = 0    # ports riding TIME_WAIT after DP close
        from repro_torch.core.policies import LB_POLICIES
        self.lb_policy = lb_policy
        self._lb_pick = LB_POLICIES[lb_policy]
        # hoisted once: the backlog fast path in _drain_queue_tbl is
        # least-loaded-only, and the string compare ran per dispatch
        self._lb_fast = lb_policy == "least_loaded"
        self.alive = True
        self.tables: Dict[str, FunctionTable] = {}
        self._cpu = env.resource(capacity=costs.dp_cores,
                                 name=f"dp{dp_id}-cpu")
        self._ports = env.resource(capacity=costs.dp_port_pool,
                                   name=f"dp{dp_id}-ports")
        self._dirty: set[str] = set()   # functions with metric changes
        self._rng = env.rng(f"dp-{dp_id}")
        self._procs = []
        self._procs.append(env.process(self._metrics_loop(), name=f"dp{dp_id}-metrics"))
        # keyed by inv_id, insertion-ordered: membership/removal must not be
        # an O(n) list scan with dataclass __eq__ — at a 10k-request cold
        # burst that scan was the single hottest line of the whole simulator
        self.inflight_requests: Dict[int, Invocation] = {}

    # -- control-plane-driven state ------------------------------------------------
    def sync_functions(self, names: List[str]) -> None:
        for n in names:
            self.tables.setdefault(n, FunctionTable())

    def add_endpoint(self, fn: str, sandbox: Sandbox) -> None:
        tbl = self.tables.setdefault(fn, FunctionTable())
        ep = tbl.endpoints.get(sandbox.sandbox_id)
        if ep is None:
            ep = tbl.endpoints[sandbox.sandbox_id] = Endpoint(
                sandbox=sandbox, capacity=self.concurrency)
            tbl.free_slots += ep.capacity
        self._check_free_slots(tbl)
        self._drain_queue_tbl(tbl, hint=ep)

    def remove_endpoint(self, fn: str, sandbox_id: int, drain: bool = True) -> None:
        tbl = self.tables.get(fn)
        if not tbl:
            return
        ep = tbl.endpoints.get(sandbox_id)
        if ep is None:
            return
        if drain and ep.in_use > 0:
            if not ep.draining:
                tbl.free_slots -= ep.capacity - ep.in_use
                ep.draining = True
        else:
            tbl.endpoints.pop(sandbox_id, None)
            if not ep.draining:
                tbl.free_slots -= ep.capacity - ep.in_use
            if self.conn_reuse:
                self._close_idle_conns(sandbox_id)

    def endpoint_count(self, fn: str) -> int:
        tbl = self.tables.get(fn)
        return len(tbl.endpoints) if tbl else 0

    @property
    def ports_in_use(self) -> int:
        """Ports currently held on this DP (open conns + TIME_WAIT holds)."""
        return self._ports.in_use

    # -- request path --------------------------------------------------------------
    def handle(self, inv: Invocation) -> Generator:
        """Full life of a request inside this DP (called by the front-end LB)."""
        c = self.costs
        inv.t_dp_arrival = self.env.now
        tbl = self.tables.get(inv.function_name)
        if tbl is None:
            inv.failed = True
            inv.failure_reason = "unknown function"
            inv.t_done = self.env.now
            self.collector.done(inv)
            return

        tbl.inflight += 1
        self.inflight_requests[inv.inv_id] = inv
        try:
            # proxy CPU cost
            yield self._cpu.acquire()
            try:
                yield self.env.timeout(c.dp_proxy_cpu)
            finally:
                self._cpu.release()

            ep = self._pick_endpoint(tbl, fn=inv.function_name)
            if ep is None:
                # cold or saturated: queue, and push a metric immediately if
                # there is no capacity at all for this function.
                inv.t_queued = self.env.now
                inv.cold = self.endpoint_count(inv.function_name) == 0
                waiter = self.env.event()
                tbl.queue.append(inv)
                inv._waiter = waiter            # type: ignore[attr-defined]
                self._notify_cp_now(inv.function_name, tbl)
                ep = yield waiter               # an Endpoint when dispatched
            yield from self._proxy(inv, tbl, ep)
        finally:
            tbl.inflight = max(0, tbl.inflight - 1)
            self._dirty.add(inv.function_name)
            self.inflight_requests.pop(inv.inv_id, None)

    def _pick_endpoint(self, tbl: FunctionTable,
                       exclude: Optional[int] = None,
                       fn: str = "") -> Optional[Endpoint]:
        """Pick an endpoint per the configured LB policy (default:
        least-loaded, the Knative policy used by every benchmark)."""
        best = self._lb_pick(tbl.endpoints, fn, exclude=exclude)
        if best is not None:
            best.in_use += 1   # reserve the slot synchronously
            tbl.free_slots -= 1  # every policy picks non-draining with free>0
        return best

    def _proxy(self, inv: Invocation, tbl: FunctionTable, ep: Endpoint) -> Generator:
        c = self.costs
        inv.t_dispatch = self.env.now
        worker = self.cluster.worker_by_id(ep.sandbox.worker_id)
        conn = None
        if self.conn_reuse:
            conn = yield from self._conn_acquire(ep.sandbox.sandbox_id)
        else:
            # capture the pool at acquire time: if the DP crashes and re-arms
            # a fresh port table before this request unwinds, the TIME_WAIT
            # release must settle against the pool the port came from
            pool = self._ports
            yield pool.acquire()
        hedge_ep = None
        try:
            jit = self._rng.lognormal(1.0, c.hop_jitter_sigma)
            yield self.env.timeout(c.grpc_call * jit)   # DP -> worker hop
            inv.t_exec_start = self.env.now
            primary = self.env.process(
                worker.execute(ep.sandbox.sandbox_id, inv.exec_time,
                               inv.payload, request=inv.request),
                name=f"exec-{inv.inv_id}")
            try:
                if self.hedge_after is None:
                    inv.result = yield primary
                else:
                    # straggler mitigation: after hedge_after with no reply,
                    # duplicate the request onto another endpoint and take
                    # whichever finishes first (idempotent functions; paper
                    # §2.1 R3 request-level semantics)
                    idx, val = yield self.env.any_of(
                        [primary, self.env.timeout(self.hedge_after)])
                    if idx == 0:
                        # a failed process delivers its exception as the
                        # any_of VALUE — re-raise so failures are handled,
                        # not returned as results
                        if not primary.ok:
                            raise val
                        inv.result = val
                    else:
                        hedge_ep = self._pick_endpoint(
                            tbl, exclude=ep.sandbox.sandbox_id,
                            fn=inv.function_name)
                        if hedge_ep is None:
                            inv.result = yield primary
                        else:
                            self.hedged += 1
                            w2 = self.cluster.worker_by_id(
                                hedge_ep.sandbox.worker_id)
                            backup = self.env.process(
                                w2.execute(hedge_ep.sandbox.sandbox_id,
                                           inv.exec_time, inv.payload,
                                           request=inv.request),
                                name=f"hedge-{inv.inv_id}")
                            idx2, val2 = yield self.env.any_of(
                                [primary, backup])
                            winner, w_ep, loser, l_ep = (
                                (primary, ep, backup, hedge_ep) if idx2 == 0
                                else (backup, hedge_ep, primary, ep))
                            if winner.ok:
                                inv.result = val2
                                if idx2 == 1:
                                    self.hedge_wins += 1
                                loser.kill()
                            else:
                                # winner died (its sandbox is gone): heal it
                                # and fall back to the surviving attempt
                                self._report_dead_endpoint(
                                    inv.function_name, w_ep)
                                try:
                                    inv.result = yield loser
                                except RuntimeError as e2:
                                    inv.failed = True
                                    inv.failure_reason = str(e2)
                                    self._report_dead_endpoint(
                                        inv.function_name, l_ep)
            except RuntimeError as e:
                inv.failed = True
                inv.failure_reason = str(e)
                self._report_dead_endpoint(inv.function_name, ep)
            yield self.env.timeout(
                c.grpc_call * self._rng.lognormal(1.0, c.hop_jitter_sigma))
        finally:
            if conn is not None:
                # keep-alive: park the connection for the next request to
                # this endpoint (or close it if the endpoint is gone)
                self._conn_release(conn, tbl)
            else:
                # ephemeral port held in TIME_WAIT after the per-request
                # connection closes
                def port_hold(env, ports=pool):
                    yield env.timeout(c.dp_port_hold)
                    ports.release()
                self.env.process(port_hold(self.env), name="port-hold")
        # a DP crash already failed-and-recorded this request (client conn
        # lost); finishing the server side must not record it twice
        crashed = (inv.failed and inv.t_done >= 0
                   and inv.failure_reason == "data plane crash")
        if not crashed:
            inv.t_done = self.env.now
            self.collector.done(inv)
        if hedge_ep is not None:
            self._release_slot(tbl, hedge_ep)
        self._release_slot(tbl, ep)

    # -- keep-alive connection pool (conn_reuse) -----------------------------
    def _conn_acquire(self, sandbox_id: int) -> Generator:
        """Check out a keep-alive conn to this endpoint — a parked one if
        available (zero events), else a new one for a fresh port."""
        stack = self._idle_conns.get(sandbox_id)
        if stack:
            conn = stack.pop()
            conn.idle_since = -1.0
            self.conn_hits += 1
            return conn
        self.conn_misses += 1
        pool = self._ports
        yield pool.acquire()
        self.conn_open += 1
        return _Conn(sandbox_id, pool)

    def _conn_release(self, conn: _Conn, tbl: FunctionTable) -> None:
        if conn.closed:
            return
        if conn.pool is not self._ports or not self.alive:
            # the DP crashed since this conn's port was acquired: the
            # rebuilt pool never saw this port — settle the old one
            conn.closed = True
            conn.pool.release()
            return
        ep = tbl.endpoints.get(conn.sandbox_id)
        if ep is None or ep.draining:
            # endpoint torn down: server-initiated close, port frees now
            self._close_conn(conn, time_wait=False)
            return
        now = self.env.now
        conn.idle_since = now
        self._idle_conns.setdefault(conn.sandbox_id, []).append(conn)
        self.env.schedule_at(now + self.conn_idle_timeout,
                             lambda: self._conn_expire(conn, now))

    def _conn_expire(self, conn: _Conn, since: float) -> None:
        """Idle timer fired: close the conn iff it is still parked from the
        instant this timer was armed (a reuse in between re-arms a fresh
        timer and this one must not fire under it)."""
        if conn.closed or conn.idle_since != since:
            return
        stack = self._idle_conns.get(conn.sandbox_id)
        if stack is not None and conn in stack:
            stack.remove(conn)
            if not stack:
                self._idle_conns.pop(conn.sandbox_id, None)
        self.conn_expired += 1
        self._close_conn(conn, time_wait=True)

    def _close_conn(self, conn: _Conn, time_wait: bool) -> None:
        conn.closed = True
        pool = conn.pool
        if pool is not self._ports:
            pool.release()      # straggler from a pre-crash life
            return
        self.conn_open -= 1
        if not time_wait:
            pool.release()      # passive close: no TIME_WAIT on our side
            return
        # active close by the DP: the port rides TIME_WAIT before freeing
        self.time_wait_ports += 1

        def _free(self=self, pool=pool):
            if pool is self._ports:
                self.time_wait_ports -= 1
            pool.release()
        self.env.schedule_at(self.env.now + self.costs.dp_port_hold, _free)

    def _close_idle_conns(self, sandbox_id: int) -> None:
        """Endpoint is gone: its parked conns got the server's FIN — close
        them all, ports free immediately (we are the passive closer)."""
        stack = self._idle_conns.pop(sandbox_id, None)
        if not stack:
            return
        for conn in stack:
            self._close_conn(conn, time_wait=False)

    def _report_dead_endpoint(self, fn: str, ep: Endpoint) -> None:
        """Dispatch hit a dead sandbox: stop routing to it and tell the CP so
        cluster state (capacity, replacement scaling) reconciles — a stale
        endpoint must cost one failed request, not an endless stream."""
        if not ep.draining:
            tbl = self.tables.get(fn)
            if tbl is not None \
                    and tbl.endpoints.get(ep.sandbox.sandbox_id) is ep:
                tbl.free_slots -= ep.capacity - ep.in_use
        ep.draining = True          # skipped by the LB; reaped on last release
        if not self.alive:
            return
        cp = self.cluster.control_plane_leader()
        if cp is not None:
            self.env.process(
                cp.report_dead_sandbox(fn, ep.sandbox.sandbox_id),
                name="dead-ep-report")

    def _release_slot(self, tbl: FunctionTable, ep: Endpoint) -> None:
        ep.in_use -= 1
        if ep.draining and ep.in_use == 0:
            tbl.endpoints.pop(ep.sandbox.sandbox_id, None)
            if self.conn_reuse:
                self._close_idle_conns(ep.sandbox.sandbox_id)
        elif not ep.draining \
                and tbl.endpoints.get(ep.sandbox.sandbox_id) is ep:
            # the slot only counts if the endpoint is still routable: a
            # release on an endpoint removed undrained (dead-sandbox
            # reconcile) frees nothing the LB could pick
            tbl.free_slots += 1
        self._drain_queue_tbl(tbl, hint=ep)

    def _drain_queue(self, fn: str) -> None:
        tbl = self.tables.get(fn)
        if tbl:
            self._drain_queue_tbl(tbl)

    def _drain_queue_tbl(self, tbl: FunctionTable,
                         hint: Optional[Endpoint] = None) -> None:
        if hint is not None and tbl.queue and self._lb_fast:
            # Backlog fast path. A request only ever queues when no endpoint
            # has a free slot, and every slot freed while the queue is
            # non-empty is consumed right here — so a backlogged function has
            # *zero* free slots, and the endpoint that just freed a slot (or
            # was just added) is the only possible pick. Dispatching to it
            # directly is decision-identical to the least-loaded scan at
            # O(1) instead of O(endpoints) — the scan per dispatch dominated
            # burst-drain wall time at 3000-endpoint burst peaks.
            # the hint must still be routable: a slot released on an endpoint
            # already evicted from the table (undrained remove, DP crash)
            # frees nothing the scan would ever have picked
            if tbl.endpoints.get(hint.sandbox.sandbox_id) is hint:
                while tbl.queue and not hint.draining \
                        and hint.in_use < hint.capacity:
                    hint.in_use += 1
                    tbl.free_slots -= 1
                    inv = tbl.queue.popleft()
                    inv._waiter.succeed(hint)   # type: ignore[attr-defined]
                if tbl.queue:
                    return  # hint exhausted; no other endpoint can be free
        while tbl.queue:
            head = tbl.queue[0]
            ep = self._pick_endpoint(tbl, fn=head.function_name)
            if ep is None:
                return
            inv = tbl.queue.popleft()
            inv._waiter.succeed(ep)   # type: ignore[attr-defined]

    def _check_free_slots(self, tbl: FunctionTable) -> None:
        """Sanitize-mode tripwire: the incremental free-slot count must equal
        the scan it replaced (counter drift would silently change urgent
        metric pushes). Zero cost outside REPRO_SANITIZE=1."""
        if self.env.sanitizer is None:
            return
        scan = sum(ep.capacity - ep.in_use
                   for ep in tbl.endpoints.values() if not ep.draining)
        assert tbl.free_slots == scan, \
            f"free_slots drift: counter={tbl.free_slots} scan={scan}"

    # -- metrics -------------------------------------------------------------------
    def _notify_cp_now(self, fn: str, tbl: FunctionTable) -> None:
        """Immediate scaling hint when requests wait with zero free capacity."""
        if not self.alive:
            return
        cp = self.cluster.control_plane_leader()
        if cp is None:
            return
        self._check_free_slots(tbl)
        # O(1) any-free-slot check: this ran as an O(endpoints) scan per
        # *queued request* — at 100k-worker churn peaks the scans were the
        # largest remaining per-creation DP cost (every creation's queue
        # build-up walks the whole endpoint table of the hot function)
        if tbl.free_slots > 0:
            return
        self.env.process(
            cp.receive_metric(self.dp_id, fn, tbl.inflight, urgent=True),
            name="metric-push")

    def _metrics_loop(self) -> Generator:
        c = self.costs
        while True:
            yield self.env.timeout(c.metrics_report_period)
            if not self.alive:
                continue
            cp = self.cluster.control_plane_leader()
            if cp is None:
                continue
            # one batched report covering every active function on this DP
            report = {fn: tbl.inflight for fn, tbl in self.tables.items()
                      if tbl.inflight > 0 or fn in self._dirty}
            self._dirty.clear()
            if report:
                self.env.process(cp.receive_metric_batch(self.dp_id, report),
                                 name="metric-batch")

    # -- failure -------------------------------------------------------------------
    def fail(self) -> List[Invocation]:
        """Crash: all in-flight requests on this DP fail (client conns lost)."""
        self.alive = False
        dropped = list(self.inflight_requests.values())
        for inv in dropped:
            if inv.t_done < 0:
                inv.failed = True
                inv.failure_reason = "data plane crash"
                inv.t_done = self.env.now
                self.collector.done(inv)
        self.inflight_requests.clear()
        for tbl in self.tables.values():
            tbl.queue.clear()
            tbl.inflight = 0
            tbl.endpoints.clear()
            tbl.free_slots = 0
        # the crashed kernel forgets its whole port table: re-arm a fresh
        # pool so recovery starts from zero ports in use. In-flight requests
        # and TIME_WAIT holds from the old life captured the old pool object
        # and settle against it — they must not leak into the recovered pool
        # (regression: tests/test_data_plane.py).
        self._ports = self.env.resource(capacity=self.costs.dp_port_pool,
                                        name=f"dp{self.dp_id}-ports")
        for stack in self._idle_conns.values():
            for conn in stack:
                conn.closed = True
        self._idle_conns.clear()
        self.conn_open = 0
        self.time_wait_ports = 0
        return dropped

    def recover(self, functions: List[str],
                endpoints: Dict[str, List[Sandbox]]) -> None:
        """Re-register with CP and repopulate caches (paper §3.4.1)."""
        self.alive = True
        self.sync_functions(functions)
        for fn, sbs in endpoints.items():  # simlint: ok(dict-iteration): snapshot built in deterministic order
            for sb in sbs:
                self.add_endpoint(fn, sb)
