"""K8s/Knative baseline cluster-manager simulator (paper §2.2 root causes).

This is the *baseline the paper measures against*, reproduced at the
queueing-mechanism level:

  * every cluster-state change is a read-modify-write against a centralized
    API server backed by a strongly-consistent store (etcd): controller ->
    API-server RPC, CPU to (de)serialize ~17 KB nested objects, serialized
    WAL fsync;
  * controllers are independent microservices that only communicate through
    watch events on the store (informer cache lag), with client-go
    token-bucket rate limiting;
  * concurrent RMWs to the same hot object (the per-function Deployment /
    ReplicaSet / Endpoints) hit optimistic-concurrency conflicts and retry
    with backoff — this is what collapses throughput under churn;
  * sandbox = Pod with a queue-proxy sidecar created *sequentially* after the
    user container, then both must pass readiness probes (Fig 1);
  * the warm path crosses istio ingress + activator + queue-proxy;
  * the autoscaler is the same KPA policy Dirigent uses (paper §4), but it
    acts through Deployment updates and sees metrics with reporting lag.

``fused=True`` models the K3s experiment (all components in one process: no
inter-component RPC, watch lag ≈ a channel op) — the paper's point is that
this barely helps because serialization + persistence dominate (C4).
``flavor="openwhisk"`` adds the Kafka hop + CouchDB read that put OpenWhisk's
warm path behind Knative's (Fig 8, [48]).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional

from repro_torch.core.abstractions import Function, Sandbox, SandboxState, WorkerNodeInfo
from repro_torch.core.autoscaler import FunctionAutoscalerState
from repro_torch.core.costmodel import CostModel, DEFAULT_COSTS, KnativeCosts
from repro_torch.core.metrics import Collector
from repro_torch.core.placement import Placer
from repro_torch.core.request import Invocation, InvocationMode
from repro_torch.simcore import Environment, Event, Interrupt


class TokenBucket:
    """client-go flow-control: qps refill with burst credit (GCRA form)."""

    def __init__(self, env: Environment, qps: float, burst: int):
        self.env = env
        self.interval = 1.0 / qps
        self.tau = burst * self.interval
        self._last_target = -1e18

    def acquire(self) -> Generator:
        now = self.env.now
        target = max(now - self.tau, self._last_target + self.interval)
        self._last_target = target
        wait = max(0.0, target - now)
        if wait > 0:
            yield self.env.timeout(wait)


class ApiServer:
    """The K8s API server + etcd pair: CPU for serialization, WAL for writes,
    optimistic concurrency on object versions."""

    def __init__(self, env: Environment, costs: KnativeCosts):
        self.env = env
        self.costs = costs
        self.cpu = env.resource(capacity=costs.apiserver_cores,
                                name="apiserver-cpu")
        self.etcd_wal = env.resource(capacity=1, name="etcd-wal")
        self.versions: Dict[str, int] = {}
        self.op_count = 0
        self.conflict_count = 0
        self.cpu_busy = 0.0

    def read(self, key: str, kb: Optional[float] = None) -> Generator:
        c = self.costs
        kb = c.small_object_kb if kb is None else kb
        yield self.cpu.acquire()
        try:
            dt = kb * c.serialize_per_kb * 0.3   # reads deserialize less
            self.cpu_busy += dt
            yield self.env.timeout(dt)
        finally:
            self.cpu.release()
        yield self.env.timeout(c.etcd_read)
        self.op_count += 1
        return self.versions.get(key, 0)

    def write(self, key: str, expect_version: Optional[int] = None,
              kb: Optional[float] = None) -> Generator:
        """Returns True on success, False on a version conflict."""
        c = self.costs
        kb = c.object_kb if kb is None else kb
        yield self.cpu.acquire()
        try:
            dt = kb * c.serialize_per_kb
            self.cpu_busy += dt
            yield self.env.timeout(dt)
        finally:
            self.cpu.release()
        cur = self.versions.get(key, 0)
        if expect_version is not None and cur != expect_version:
            self.conflict_count += 1
            return False
        yield self.etcd_wal.acquire()
        try:
            yield self.env.timeout(c.etcd_fsync)
        finally:
            self.etcd_wal.release()
        self.versions[key] = cur + 1
        self.op_count += 1
        return True

    def rmw(self, key: str, bucket: TokenBucket, kb: Optional[float] = None,
            max_retries: int = 8) -> Generator:
        """Full controller read-modify-write with conflict retries."""
        c = self.costs
        for attempt in range(max_retries):
            yield from bucket.acquire()
            yield self.env.timeout(c.rpc)
            ver = yield from self.read(key, kb=c.small_object_kb)
            yield self.env.timeout(c.rpc)
            ok = yield from self.write(key, expect_version=ver, kb=kb)
            if ok:
                return attempt
            yield self.env.timeout(c.conflict_backoff * (1.5 ** attempt))
        return max_retries


@dataclass
class PodEndpoint:
    sandbox: Sandbox
    capacity: int = 1
    in_use: int = 0
    draining: bool = False

    @property
    def free(self) -> int:
        return 0 if self.draining else self.capacity - self.in_use


@dataclass
class KnFunctionState:
    function: Function
    autoscaler: FunctionAutoscalerState
    endpoints: Dict[int, PodEndpoint] = field(default_factory=dict)
    queue: List[Invocation] = field(default_factory=list)
    inflight: int = 0
    creating: int = 0

    @property
    def ready_count(self) -> int:
        return len(self.endpoints)


class KnativeCluster:
    """Knative/K8s (or fused-K3s / OpenWhisk-flavored) FaaS platform model."""

    def __init__(self, env: Environment, n_workers: int = 93,
                 costs: Optional[CostModel] = None,
                 fused: bool = False, flavor: str = "knative",
                 sandbox_concurrency: int = 1):
        self.env = env
        self.costs = (costs or DEFAULT_COSTS).knative
        self.fused = fused
        self.flavor = flavor
        self.collector = Collector()
        self.api = ApiServer(env, self.costs)
        self.placer = Placer()
        self.functions: Dict[str, KnFunctionState] = {}
        self.workers: Dict[int, WorkerNodeInfo] = {}
        self._worker_kernel_locks: Dict[int, object] = {}
        self._activator_cpu = env.resource(capacity=self.costs.activator_cores)
        self._workqueue = env.resource(capacity=self.costs.workqueue_workers)
        self._scheduler = env.resource(capacity=1)
        self._buckets: Dict[str, TokenBucket] = {}
        self._sandbox_ids = itertools.count(1)
        self._inv_ids = itertools.count(1)
        self._rng = env.rng("knative")
        self.registered_count = 0
        self.alive = True
        for wid in range(n_workers):
            info = WorkerNodeInfo(worker_id=wid, name=f"w{wid}",
                                  ip=(10, 0, wid // 250, wid % 250), port=9000)
            self.workers[wid] = info
            self.placer.add_node(wid, info.cpu_capacity_millis,
                                 info.mem_capacity_mb)
            self._worker_kernel_locks[wid] = env.resource(
                capacity=1, name=f"kn-kernel-lock-w{wid}")
        self._loops = [env.process(self._kpa_loop(), name="kpa")]

    # -- plumbing ------------------------------------------------------------------
    def _bucket(self, controller: str) -> TokenBucket:
        if controller not in self._buckets:
            self._buckets[controller] = TokenBucket(
                self.env, self.costs.controller_qps, self.costs.controller_burst)
        return self._buckets[controller]

    def _hop(self) -> Generator:
        """Inter-component hop: RPC normally, a channel op when fused (K3s)."""
        yield self.env.timeout(2e-6 if self.fused else self.costs.rpc)

    def _watch(self) -> Generator:
        """Watch/informer propagation between controllers."""
        yield self.env.timeout(2e-6 if self.fused else self.costs.watch_propagation)

    # -- registration (paper §5.2.4) --------------------------------------------------
    def register_function(self, fn: Function) -> Generator:
        c = self.costs
        st = KnFunctionState(function=fn,
                             autoscaler=FunctionAutoscalerState(fn.scaling))
        # Knative ascribes multiple objects per function: service, config,
        # revision, route, SKS, deployment, ingress — each an API-server RMW
        # through its own controller, chained by watch events.
        for i in range(c.registration_objects):
            yield from self._watch()
            yield from self.api.rmw(f"reg/{fn.name}/{i}", self._bucket(f"reg{i}"))
            yield self.env.timeout(c.registration_xds_sync)
        # ingress/route resync grows with the number of existing functions
        grow = c.registration_growth * self.registered_count
        if grow > 0:
            yield self.api.cpu.acquire()
            try:
                self.api.cpu_busy += grow
                yield self.env.timeout(grow)
            finally:
                self.api.cpu.release()
        self.functions[fn.name] = st
        self.registered_count += 1
        return fn.name

    def register_sync(self, fn: Function) -> None:
        done = self.env.event()

        def reg(env):
            yield from self.register_function(fn)
            done.succeed(None)

        self.env.process(reg(self.env), name=f"register-{fn.name}")
        self.env.run_until_event(done)

    # -- invocation path -----------------------------------------------------------------
    def invoke(self, function_name: str, exec_time: float,
               mode: InvocationMode = InvocationMode.SYNC) -> Invocation:
        inv = Invocation(inv_id=next(self._inv_ids),
                         function_name=function_name,
                         arrival=self.env.now, exec_time=exec_time, mode=mode)
        self.env.process(self._handle(inv), name=f"kninv-{inv.inv_id}")
        return inv

    def _handle(self, inv: Invocation) -> Generator:
        c = self.costs
        st = self.functions.get(inv.function_name)
        if st is None or not self.alive:
            inv.failed = True
            inv.failure_reason = "unknown function or platform down"
            inv.t_done = self.env.now
            self.collector.done(inv)
            return
        # front-end LB -> istio ingress -> activator
        yield self.env.timeout(c.lb_hop)
        yield self.env.timeout(c.istio_hop)
        if self.flavor == "openwhisk":
            # OpenWhisk: Kafka + CouchDB on the critical path [48]
            yield self.env.timeout(5.0e-3)     # kafka produce/consume
            yield self.env.timeout(10.0e-3)    # couchdb activation record
        yield self._activator_cpu.acquire()
        try:
            yield self.env.timeout(c.activator_cpu)
        finally:
            self._activator_cpu.release()

        st.inflight += 1
        inv.t_dp_arrival = self.env.now
        try:
            ep = self._pick_endpoint(st)
            if ep is None:
                inv.t_queued = self.env.now
                inv.cold = st.ready_count == 0
                waiter = self.env.event()
                st.queue.append(inv)
                inv._waiter = waiter   # type: ignore[attr-defined]
                if st.ready_count + st.creating == 0:
                    # scale-from-zero: the activator pokes the autoscaler
                    # immediately rather than waiting for the 2 s KPA tick
                    st.autoscaler.record_metric(self.env.now,
                                                float(st.inflight))
                    delta = max(st.autoscaler.desired(self.env.now, 0), 1)
                    st.creating += delta
                    self.env.process(self._scale_up(st, delta),
                                     name=f"scaleup0-{inv.function_name}")
                ep = yield waiter
            # activator -> pod hop + queue-proxy sidecar hop
            yield self.env.timeout(c.pod_hop + c.queue_proxy_hop)
            inv.t_dispatch = self.env.now
            inv.t_exec_start = self.env.now
            yield self.env.timeout(inv.exec_time)
            inv.t_done = self.env.now
            self.collector.done(inv)
            self._release(st, ep)
        finally:
            st.inflight = max(0, st.inflight - 1)

    def _pick_endpoint(self, st: KnFunctionState) -> Optional[PodEndpoint]:
        best = None
        for ep in st.endpoints.values():  # simlint: ok(dict-iteration): pod creation order is deterministic
            if ep.free > 0 and (best is None or ep.in_use < best.in_use):
                best = ep
        if best is not None:
            best.in_use += 1
        return best

    def _release(self, st: KnFunctionState, ep: PodEndpoint) -> None:
        ep.in_use -= 1
        if ep.draining and ep.in_use == 0:
            st.endpoints.pop(ep.sandbox.sandbox_id, None)
        self._drain(st)

    def _drain(self, st: KnFunctionState) -> None:
        while st.queue:
            ep = self._pick_endpoint(st)
            if ep is None:
                return
            inv = st.queue.pop(0)
            inv._waiter.succeed(ep)   # type: ignore[attr-defined]

    # -- autoscaling (KPA through K8s machinery) --------------------------------------------
    def _kpa_loop(self) -> Generator:
        c = self.costs
        while True:
            yield self.env.timeout(c.autoscale_period)
            if not self.alive:
                continue
            for name, st in list(self.functions.items()):
                # metrics arrive with reporting lag; sample current inflight
                st.autoscaler.record_metric(self.env.now, float(st.inflight))
                current = st.ready_count + st.creating
                desired = st.autoscaler.desired(self.env.now, current)
                if desired > current:
                    delta = desired - current
                    st.creating += delta
                    self.env.process(self._scale_up(st, delta),
                                     name=f"scaleup-{name}")
                elif desired < current and st.creating == 0:
                    for ep in self._victims(st, current - desired):
                        self.env.process(self._delete_pod(st, ep),
                                         name=f"del-{name}")

    def _victims(self, st: KnFunctionState, n: int) -> List[PodEndpoint]:
        pods = sorted(st.endpoints.values(), key=lambda e: -e.sandbox.sandbox_id)
        out = []
        for ep in pods:
            if len(out) == n:
                break
            ep.draining = True
            out.append(ep)
        return out

    # -- pod lifecycle: the reconcile chain (paper §2.2) ----------------------------------------
    def _bg_load(self) -> None:
        """Asynchronous per-creation API-server work (Events, status updates,
        informer resyncs, istio xDS pushes). Shares the API-server CPU with
        the critical chain — this is what saturates it at ~2 creations/s."""
        c = self.costs
        n_chunks = max(1, int(round(c.bg_cpu_per_creation / c.bg_chunk)))

        def chunk(env, delay):
            yield env.timeout(delay)
            yield self.api.cpu.acquire()
            try:
                self.api.cpu_busy += c.bg_chunk
                yield env.timeout(c.bg_chunk)
            finally:
                self.api.cpu.release()

        for _ in range(n_chunks):
            # spread across the creation's lifetime (status syncs, resyncs)
            self.env.process(chunk(self.env, self._rng.uniform(0, c.bg_spread)),
                             name="api-bg")

    def _scale_up(self, st: KnFunctionState, delta: int) -> Generator:
        """One reconcile *wave* creating ``delta`` pods for a function.

        Batch semantics match K8s: the Deployment/ReplicaSet updates happen
        once per wave, the RS controller then creates ``delta`` Pod objects
        (small writes, rate-limited), the scheduler binds them serially,
        kubelets boot in parallel, and the Endpoints controller publishes one
        batched update when pods turn ready. This is why a 100-pod burst for
        ONE function is far faster than 100 independent creations — and why
        the steady-state cap (~2/s, API-server CPU) still bites for the
        many-function trace.
        """
        c = self.costs
        fn = st.function.name
        try:
            # bounded controller workqueue concurrency (workers per controller)
            yield self._workqueue.acquire()
            try:
                # wave-level RMWs on hot per-function objects
                yield from self.api.rmw(f"deploy/{fn}", self._bucket("kpa"))
                yield from self._watch()
                yield from self.api.rmw(f"rs/{fn}", self._bucket("deployment"))
                yield from self._watch()
            finally:
                self._workqueue.release()

            # per-pod pipeline, in parallel
            done_pods: List[Sandbox] = []
            waiters = []
            for _ in range(delta):
                ev = self.env.event()
                waiters.append(ev)
                self.env.process(self._boot_pod(st, done_pods, ev),
                                 name=f"boot-{fn}")
            for ev in waiters:
                yield ev

            if done_pods:
                # one batched endpoints + SKS update for the wave
                yield from self.api.rmw(f"endpoints/{fn}",
                                        self._bucket("endpoints"))
                yield from self._watch()
                yield from self.api.rmw(f"sks/{fn}", self._bucket("sks"))
                yield from self._watch()
                for sb in done_pods:
                    st.endpoints[sb.sandbox_id] = PodEndpoint(
                        sandbox=sb, capacity=max(
                            1, int(st.function.scaling.target_concurrency)))
                    self.collector.sandbox_creations += 1
                    self.collector.event(self.env.now, "sandbox-created", fn)
                self._drain(st)
        finally:
            st.creating = max(0, st.creating - delta)

    def _boot_pod(self, st: KnFunctionState, done_pods: list,
                  done_ev) -> Generator:
        c = self.costs
        fn = st.function.name
        try:
            self._bg_load()
            sid = next(self._sandbox_ids)
            # RS controller creates the Pod object (small write, rate-limited)
            yield from self._bucket("replicaset").acquire()
            _ = yield from self.api.write(f"pod/{fn}/{sid}",
                                          kb=c.small_object_kb)
            # scheduler: a single serialized queue (~100 binds/s)
            yield self._scheduler.acquire()
            try:
                yield self.env.timeout(c.scheduler_bind)
                wid = self.placer.place(st.function.scaling.cpu_req_millis,
                                        st.function.scaling.mem_req_mb)
            finally:
                self._scheduler.release()
            if wid is None:
                return
            yield from self.api.write(f"pod/{fn}/{sid}",
                                      kb=c.small_object_kb)   # binding
            yield from self._watch()
            # kubelet boots user container then the queue-proxy sidecar,
            # sequentially, then both pass readiness probes (Fig 1)
            yield self.env.timeout(c.kubelet_sync_period * self._rng.random())
            lock = self._worker_kernel_locks[wid]
            for _ in range(2):
                yield lock.acquire()
                try:
                    # simlint: ok(held-lock-timeout): modeled kernel hold
                    yield self.env.timeout(0.052)
                finally:
                    lock.release()
                boot = self._rng.lognormal(c.user_container_create - 0.052, 0.3)
                yield self.env.timeout(max(boot, 1e-4))
            yield self.env.timeout(c.readiness_probe_wait)
            # kubelet posts pod status (big nested Pod object)
            yield from self.api.rmw(f"pod/{fn}/{sid}", self._bucket("kubelet"))
            done_pods.append(Sandbox(
                sandbox_id=sid, function_name=fn, ip=self.workers[wid].ip,
                port=st.function.port, worker_id=wid,
                state=SandboxState.READY))
        finally:
            done_ev.succeed(None)

    def _delete_pod(self, st: KnFunctionState, ep: PodEndpoint) -> Generator:
        fn = st.function.name
        yield from self.api.rmw(f"deploy/{fn}", self._bucket("kpa"))
        yield from self._watch()
        yield from self.api.rmw(f"rs/{fn}", self._bucket("deployment"))
        yield from self._watch()
        yield from self.api.rmw(f"pod/{fn}/{ep.sandbox.sandbox_id}",
                                self._bucket("replicaset"))
        yield from self.api.rmw(f"endpoints/{fn}", self._bucket("endpoints"))
        if ep.in_use == 0:
            st.endpoints.pop(ep.sandbox.sandbox_id, None)
        self.placer.release(ep.sandbox.worker_id,
                            st.function.scaling.cpu_req_millis,
                            st.function.scaling.mem_req_mb)
        self.collector.sandbox_teardowns += 1

    # -- failure injection (paper §5.4) ------------------------------------------------------
    def fail_control_plane(self) -> None:
        """All controller microservices crash; K8s restarts them one by one."""
        self.alive = False
        self.collector.event(self.env.now, "cp-failed", None)
        self.env.process(self._recover_control_plane(), name="kn-cp-recover")

    def _recover_control_plane(self) -> Generator:
        c = self.costs
        yield self.env.timeout(c.pod_restart_delay)
        # each microservice (autoscaler, controller, webhook, activator...)
        # recovers at its own pace; the system serves again when all are up
        yield self.env.timeout(self._rng.uniform(0.5, 1.0)
                               * c.component_recover_spread)
        self.alive = True
        self.collector.event(self.env.now, "cp-recovered", None)

    def fail_data_plane(self) -> Generator:
        """Istio ingress gateway + activator crash (C11: ~15 s recovery)."""
        self.alive = False
        self.collector.event(self.env.now, "dp-failed", None)
        yield self.env.timeout(self.costs.pod_restart_delay)
        yield self.env.timeout(self.costs.istio_gateway_recover)
        self.alive = True
        self.collector.event(self.env.now, "dp-recovered", None)
