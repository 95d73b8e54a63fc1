"""Worker-node daemon model (paper §4 "Worker node software stack").

Implements the sandbox lifecycle with the two runtimes the paper evaluates:

  * ``containerd``  — lognormal creation latency; a per-node *kernel lock*
    resource serializes part of each creation (Linux net-stack/iptables
    contention — this is what caps the cluster at ~1750 creations/s, C2);
  * ``firecracker`` — microVM snapshot restore, 40 ms median, much smaller
    kernel-serialized section (the control plane becomes the bottleneck, C1).

Each node keeps a pool of pre-created recyclable network configurations
(paper §4): creations take a config from the pool (cheap) or pay the full
Linux network-stack cost when the pool is empty; a background process
recycles configs released by teardowns.

The pool replenisher is *demand-driven and grid-aligned*: instead of a
per-node poll every ``netcfg_replenish_period`` (which at 5000 nodes is
~97% of all simulator events while doing nothing), a refill callback is
scheduled only while the pool is below target, at exactly the instants the
polling loop would have refilled — the tick grid is advanced by the same
repeated float addition the polling loop's ``timeout(period)`` chain
performed, so refill times (and every downstream latency statistic) are
bit-identical while the idle ticks vanish (tests/test_simcore.py pins the
equivalence against a reference polling loop).

The daemon is distinct from the sandboxes: ``fail_daemon()`` stops heartbeats
and the control API while sandboxes keep serving (paper §5.4 "worker daemon
failure"); ``fail_node()`` additionally kills every sandbox.

Mechanism → paper section map (claim ids C1..C12 as in costmodel.py):

  * ``create_sandbox`` — §4 "Worker node software stack": lognormal runtime
    boot (``containerd_create_median`` ≈ 110 ms, Fig 7's 10–100 ms band;
    ``firecracker_create_median`` ≈ 40 ms snapshot restore, §5.2.3) behind
    the per-node kernel-lock slice (C2: containerd's serialized net-stack /
    iptables work caps 93 nodes at ~1750 creations/s).
  * netns pool (``netcfg_*``) — §4 pre-created recyclable network configs:
    pooled grab ≈ 1 ms on the boot path; an empty pool pays the full Linux
    network-stack cost (60 ms) — the burst cliff the pool exists to hide.
  * ``kill_sandbox`` / recycle — §4 sandbox teardown off the critical path:
    async dismantle (``sandbox_teardown``), config back to the pool.
  * health probes (``health_probe_period``) — §3.4 worker-local liveness:
    the daemon probes its sandboxes and reports losses to the CP, which is
    how sandbox state is *reconstructed* rather than trusted (Table 3).
  * heartbeats — §3.4 failure detection (C9 load side-effect): every beat
    also touches the owning CP shard's shared structures
    (``cp_heartbeat_lock_hold``), degrading creation throughput at 5000
    workers — the contention the sharded CP isolates per shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Generator, Optional

from repro_torch.core.abstractions import Sandbox, SandboxState, WorkerNodeInfo
from repro_torch.core.costmodel import DirigentCosts
from repro_torch.simcore import Environment, Interrupt, Store


@dataclass
class SandboxRuntime:
    """A sandbox running on this node."""

    sandbox: Sandbox
    ready: bool = False
    # execution bookkeeping (the DP owns slot accounting; this is ground truth
    # used to fail in-flight requests on node death)
    executing: int = 0


class WorkerDaemon:
    def __init__(self, env: Environment, info: WorkerNodeInfo,
                 costs: DirigentCosts, runtime: str = "firecracker",
                 create_hook: Optional[Callable] = None,
                 teardown_hook: Optional[Callable] = None,
                 live_backend: Optional[object] = None):
        self.env = env
        self.info = info
        self.costs = costs
        self.runtime = runtime
        self.sandboxes: Dict[int, SandboxRuntime] = {}
        self.daemon_alive = True
        self.node_alive = True
        self.create_hook = create_hook  # live-mode: build the real replica
        # symmetric reclaim: called as teardown_hook(sandbox_id, drain) —
        # drain=True from graceful kill_sandbox (in-slot live requests
        # finish, the wall-side mirror of the CP's teardown_drain_grace),
        # drain=False from fail_node (in-slot requests fail)
        self.teardown_hook = teardown_hook
        # live-mode invoke path: admit/collect LiveRequests (repro_torch.live)
        self.live_backend = live_backend
        self._kernel_lock = env.resource(
            capacity=1, name=f"kernel-lock-w{info.worker_id}")
        self._netcfg_pool = env.store(name=f"netcfg-w{info.worker_id}")
        for _ in range(costs.netcfg_pool_size):
            self._netcfg_pool.put(object())
        self._rng = env.rng(f"worker-{info.worker_id}")
        self.creations = 0
        self.slow_factor = 1.0     # straggler injection (tests/benchmarks)
        # demand-driven replenisher state: the tick-grid accumulator starts
        # where the old polling process started (daemon construction time)
        # and only ever advances by += period — the identical float-add chain
        # the polling loop's timeout(period) produced, so refill instants
        # match it bit for bit
        self._netcfg_next_tick = env.now
        self._netcfg_refill_pending = False

    def _arm_netcfg_refill(self) -> None:
        """Schedule the next pool refill, iff the pool is below target and no
        refill is already pending (paper §4: pools of pre-created network
        configurations). Costs one heap event per actual refill; a full pool
        costs nothing — the polling loop this replaces burned one event per
        node per 25 ms forever."""
        if self._netcfg_refill_pending or not self.node_alive:
            return
        if len(self._netcfg_pool) >= self.costs.netcfg_pool_size:
            return
        t = self._netcfg_next_tick
        period = self.costs.netcfg_replenish_period
        now = self.env.now
        while t <= now:                  # next grid instant strictly > now
            t += period
        self._netcfg_next_tick = t
        self._netcfg_refill_pending = True
        self.env.schedule_at(t, self._netcfg_refill_fire)

    def _netcfg_refill_fire(self) -> None:
        self._netcfg_refill_pending = False
        if not self.node_alive:
            return
        pool, size = self._netcfg_pool, self.costs.netcfg_pool_size
        if len(pool) < size:
            pool.put(object())
            if len(pool) < size:         # still short: keep walking the grid
                t = self._netcfg_next_tick + self.costs.netcfg_replenish_period
                self._netcfg_next_tick = t
                self._netcfg_refill_pending = True
                self.env.schedule_at(t, self._netcfg_refill_fire)

    # -- sandbox lifecycle --------------------------------------------------
    def create_sandbox(self, sandbox: Sandbox) -> Generator:
        """Create + boot a sandbox; returns when it passes health probes."""
        if not (self.daemon_alive and self.node_alive):
            raise RuntimeError("worker daemon unavailable")
        c = self.costs
        rt = SandboxRuntime(sandbox=sandbox)
        self.sandboxes[sandbox.sandbox_id] = rt

        # 1) network configuration: pooled fast path vs full net-stack cost.
        # Taking a config is the demand signal that arms the (grid-aligned)
        # refill timer; an empty pool is demand too — the polling loop would
        # have refilled at the next tick either way.
        if len(self._netcfg_pool):
            self._netcfg_pool.items.popleft()
            self._arm_netcfg_refill()
            yield self.env.timeout(c.netcfg_pooled)
        else:
            self._arm_netcfg_refill()
            yield self.env.timeout(c.netcfg_fresh)

        # 2) serialized kernel section (cgroups/netns/iptables updates).
        lock_hold = (c.containerd_kernel_lock if self.runtime == "containerd"
                     else c.firecracker_kernel_lock)
        yield self._kernel_lock.acquire()
        try:
            # simlint: ok(held-lock-timeout): modeled kernel critical section
            yield self.env.timeout(lock_hold)
        finally:
            self._kernel_lock.release()

        # 3) parallel portion of the boot (image start / snapshot load).
        if self.runtime == "containerd":
            boot = self._rng.lognormal(c.containerd_create_median
                                       - lock_hold, c.containerd_create_sigma)
        else:
            boot = self._rng.lognormal(c.firecracker_create_median
                                       - lock_hold, c.firecracker_create_sigma)
        yield self.env.timeout(max(boot, 1e-4))

        if self.create_hook is not None:
            self.create_hook(sandbox)

        # 4) health probe: daemon polls every probe period; first probe after
        #    boot completion passes.
        yield self.env.timeout(self._rng.uniform(0, c.health_probe_period))

        if not (self.daemon_alive and self.node_alive):
            raise RuntimeError("worker died during sandbox creation")
        rt.ready = True
        sandbox.state = SandboxState.READY
        self.creations += 1
        return sandbox

    def kill_sandbox(self, sandbox_id: int) -> Generator:
        """Teardown: dismantle fs, netns, cgroups; recycle the net config."""
        rt = self.sandboxes.pop(sandbox_id, None)
        if rt is None:
            return
        if self.teardown_hook is not None:
            # reclaim the live replica with drain semantics: the CP already
            # waited teardown_drain_grace, so remaining in-slot requests are
            # stragglers — finish them rather than fail them
            self.teardown_hook(sandbox_id, True)
        yield self.env.timeout(self.costs.sandbox_teardown)
        # recycle the network config back into the pool after a delay — a
        # plain scheduled callback (one heap event), not a process
        self.env.schedule_at(self.env.now + self.costs.netcfg_recycle,
                             self._netcfg_recycle_fire)

    def _netcfg_recycle_fire(self) -> None:
        self._netcfg_pool.put(object())

    def list_sandboxes(self) -> list[Sandbox]:
        """Recovery API: CP reconstructs sandbox state from here (§3.4.1)."""
        return [rt.sandbox for rt in self.sandboxes.values() if rt.ready]

    # -- request execution -----------------------------------------------------
    def execute(self, sandbox_id: int, exec_time: float,
                payload: Optional[Callable] = None,
                request: Optional[object] = None) -> Generator:
        """Execute one invocation inside a sandbox. ``request`` is a live
        ``LiveRequest`` routed into this sandbox's replica via the worker's
        ``live_backend`` (admit into a batcher slot, collect tokens)."""
        rt = self.sandboxes.get(sandbox_id)
        if rt is None or not rt.ready or not self.node_alive:
            raise RuntimeError("sandbox gone")
        c = self.costs
        rt.executing += 1
        try:
            ticket = None
            if request is not None and self.live_backend is not None:
                # admit BEFORE yielding the dispatch overhead: requests that
                # are concurrent in sim time land in the replica's batcher
                # slots together and share decode steps (the first collect
                # pumps for everyone admitted by then)
                ticket = self.live_backend.admit(sandbox_id, request)
            yield self.env.timeout(c.worker_nat_hop + c.exec_slot_overhead)
            if ticket is not None:
                # live mode: real inference; bill its wall time to the clock
                import time
                t0 = time.perf_counter()  # simlint: ok(wall-clock): live mode bills real work
                result = self.live_backend.collect(ticket)
                yield self.env.timeout(time.perf_counter() - t0)  # simlint: ok(wall-clock): live mode bills real work
                if result.failed:
                    raise RuntimeError(result.failure_reason
                                       or "live request failed")
            elif payload is not None:
                # live mode: run real work; bill its wall time to the clock
                import time
                t0 = time.perf_counter()  # simlint: ok(wall-clock): live mode bills real work
                result = payload()
                yield self.env.timeout(time.perf_counter() - t0)  # simlint: ok(wall-clock): live mode bills real work
            else:
                result = None
                yield self.env.timeout(exec_time * self.slow_factor)
            if not self.node_alive:
                raise RuntimeError("node failed during execution")
            return result
        finally:
            rt.executing -= 1

    # -- failure injection --------------------------------------------------------
    def fail_daemon(self) -> None:
        self.daemon_alive = False

    def recover_daemon(self) -> None:
        self.daemon_alive = True

    def fail_node(self) -> None:
        self.daemon_alive = False
        self.node_alive = False
        for rt in self.sandboxes.values():
            rt.ready = False
        if self.teardown_hook is not None:
            for sid in list(self.sandboxes):
                # node death: no drain — in-slot live requests fail
                self.teardown_hook(sid, False)
        self.sandboxes.clear()
