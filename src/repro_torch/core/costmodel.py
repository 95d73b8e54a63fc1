"""Calibrated service-time constants for the cluster-manager simulations.

Every constant is traceable either to a number stated in the paper or to a
calibration target (a paper claim C1..C12, see DESIGN.md §1 and
docs/benchmarks.md). The *loaded* behaviour — saturation throughput, tail
blow-ups — is NOT encoded here; it emerges from queueing at the modeled
resources.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields


@dataclass
class DirigentCosts:
    """Dirigent mechanism constants and the paper measurements they model.

    Key calibration anchors (claim ids C1..C12 are cross-referenced from the
    benchmarks; see docs/benchmarks.md for the figure mapping):

    * ``cp_scale_lock_hold`` — the C1 bottleneck. The paper attributes
      Dirigent's ~2500 sandbox creations/s ceiling (93 nodes, Fig 7) to
      "access congestion on shared data structures used for autoscaling":
      0.36 ms of serialized state-update work per creation ≈ 2778/s through
      one lock. With ``cp_shards > 1`` each control-plane shard holds its own
      lock over its slice, so the modeled ceiling scales with the shard count
      (benchmarks/churn_scale.py ``cp_shard_sweep``).
    * ``cp_heartbeat_lock_hold`` — C9: heartbeat processing touches the same
      shared structures, which is what degrades creation throughput at 5000
      workers (5000 workers × 2 hb/s × 12 µs ≈ 12% of one lock).
    * ``cp_cross_shard_op`` — sharded-CP fan-out hop: the in-memory handoff
      one shard pays per foreign shard it touches (work-stealing capacity
      spill, post-eviction reconcile fan-out, function-migration handoff).
      Modeled like ``channel_op`` (a Go channel/atomic handoff, no network),
      slightly dearer for the extra synchronization; it only exists when
      ``cp_shards > 1``.
    * ``cp_rebalance_*`` / ``cp_steal_backoff`` — load-adaptive sharding
      policy knobs (hot-shard rebalancing + work-stealing spill); no paper
      anchor (the paper's CP is the static single-shard configuration).
      Operator guidance: docs/operations.md.
    * ``grpc_call`` / ``channel_op`` — paper §3: Dirigent components talk
      gRPC across processes but exchange information through in-memory
      channels inside the monolithic CP (vs RPC+etcd round-trips in K8s).
    * ``persist_write`` (+ sigma/stall) — C3: fsync'd Redis AOF append; with
      sandbox state persisted on the critical path (the ablation) creation
      throughput caps at ~1000/s and p99 surges from AOF-rewrite stalls.
    * ``containerd_create_median`` / ``firecracker_create_median`` — Fig 7
      regimes: containerd cold boots in the 100 ms band and is kernel-lock
      bound at ~1750/s on 93 nodes (C2); Firecracker snapshot restores at
      ~40 ms p50 (paper §5.2.3).
    * ``raft_*`` / ``cp_recovery_*`` — C10: detect + elect + fetch + DP sync
      ≈ 10 ms control-plane failover.
    * ``lb_reconfigure`` / ``lb_health_check`` — C11: keepalived/HAProxy
      failover ≈ 2 s end to end.
    """

    # -- networking --------------------------------------------------------
    grpc_call: float = 0.3e-3          # one gRPC hop (paper §4: components talk gRPC)
    lb_hop: float = 0.2e-3             # HAProxy front-end hop
    channel_op: float = 2e-6           # in-memory Go channel handoff (monolith)
    worker_nat_hop: float = 0.2e-3     # iptables NAT on the worker node
    hop_jitter_sigma: float = 0.35     # lognormal jitter on network hops (p99)

    # -- data plane ---------------------------------------------------------
    dp_proxy_cpu: float = 0.15e-3      # per-request CPU in the DP proxy
    dp_cores: int = 10                 # xl170: 10 physical cores
    dp_port_pool: int = 28_000         # ephemeral ports per DP node
    dp_port_hold: float = 20.0         # TIME_WAIT-ish hold per connection
    metrics_report_period: float = 0.25  # DP -> CP autoscaling metric push

    # -- multi-data-plane serving (dp_spread_* / dp_conn_*) ------------------
    # The DP-side twin of the cp_* scaling knobs: the paper's C5 ceiling
    # (one DP's ephemeral ports cap the warm path; 28k ports / 20 s
    # TIME_WAIT ≈ 1400 conn/s sustained) is a *per-DP* limit, so a single
    # hot function — sticky to one DP under function-hash steering — hits
    # it no matter how many DPs exist. No paper anchor (the paper's front
    # end is sticky, one-connection-per-request); all of these only take
    # effect via ``Cluster(dp_spread_enabled=True)`` / ``dp_conn_reuse`` —
    # the defaults keep the sticky no-reuse front end bit-identically.
    # Operator guidance: docs/operations.md.
    dp_spread_width: int = 3           # DP-set size for a spread function:
    #                                    members divide its connection load,
    #                                    but each extra member dilutes the
    #                                    in-flight signal one DP aggregates
    dp_spread_min_rate: float = 1000.0  # front-end arrivals/s before a
    #                                    function is spread — below the
    #                                    ~1400 conn/s port ceiling so the
    #                                    set widens before ports convoy
    dp_spread_window: float = 1.0      # arrival-rate measurement window
    dp_spread_cooldown: float = 10.0   # a spread function folds back to its
    #                                    sole DP only after staying under
    #                                    half of min_rate this long (bounds
    #                                    widen/narrow flapping on bursts)
    dp_conn_reuse: bool = False        # keep-alive connection pool on the
    #                                    invoke path: a port is acquired per
    #                                    *connection* and reused across
    #                                    requests to the same endpoint,
    #                                    instead of one port + TIME_WAIT
    #                                    hold per request
    dp_conn_idle_timeout: float = 60.0  # idle keep-alive expiry; a timed-out
    #                                    conn closes client-side, so its
    #                                    port pays the dp_port_hold
    #                                    TIME_WAIT (endpoint-teardown closes
    #                                    are server-side FINs: port freed
    #                                    immediately)
    cp_ep_flush_coalesce: bool = False  # batch the CP->DP endpoint broadcast
    #                                    across CP shards per DP: all shards'
    #                                    updates queued in one flush window
    #                                    ride one combined broadcast (M per-DP
    #                                    deliveries per turn instead of
    #                                    N shards x M DPs)

    # -- control plane ------------------------------------------------------
    cp_sched_cpu: float = 0.05e-3      # autoscale+place decision compute ("fast")
    cp_heartbeat_lock_hold: float = 12e-6  # heartbeat touch of shared health
    #                                    structures (C9: degrades creation
    #                                    throughput at 5000 workers)
    cp_scale_lock_hold: float = 0.36e-3  # shared autoscaling state lock per
    #                                    sandbox create/destroy. C1: caps the CP
    #                                    at ~2500 creations/s (paper: "access
    #                                    congestion on shared data structures
    #                                    used for autoscaling").
    cp_cross_shard_op: float = 4e-6    # sharded-CP fan-out hop per foreign
    #                                    shard touched (capacity spill,
    #                                    post-eviction reconcile); in-memory,
    #                                    ~2x channel_op for the extra sync.
    #                                    Unused when cp_shards == 1.
    autoscale_period: float = 2.0      # autoscaler evaluation tick (KPA default)
    recovery_no_downscale: float = 60.0  # paper §3.4.1

    # -- load-adaptive sharding (cp_rebalance_* / work stealing) -------------
    # These are policy knobs for the load-adaptive sharded CP (the follow-on
    # to C1/C9 this repo adds; see docs/operations.md for operator guidance).
    # They model no paper measurement — the paper's CP is the cp_shards=1 /
    # rebalancing-off configuration — so they only take effect when
    # ``Cluster(cp_rebalance_enabled=True)`` (rebalancer) or cp_shards > 1
    # (work-stealing spill) is selected.
    cp_rebalance_period: float = 1.0   # rebalancer tick: long enough to
    #                                    smooth burst noise, short enough to
    #                                    react within a few autoscale periods
    cp_rebalance_hot_factor: float = 2.0  # migrate only when the hottest
    #                                    shard's load signal exceeds this
    #                                    multiple of the coldest's
    cp_rebalance_max_moves: int = 8    # max functions migrated per handoff
    cp_rebalance_min_load: float = 1e-3  # hot-shard floor (seconds of lock
    #                                    wait per tick): below it, imbalance
    #                                    is noise and migration pure overhead
    cp_rebalance_cooldown: float = 5.0  # per-function re-migration holdoff:
    #                                    bounds ping-ponging of a function
    #                                    whose load dominates every shard
    cp_steal_backoff: float = 0.05     # a capacity probe that found a victim
    #                                    shard full demotes it to the end of
    #                                    the steal order for this long, so a
    #                                    saturated cluster degrades to the
    #                                    deterministic round-robin probe

    # -- per-function creation sharding (cp_fn_split_*) ----------------------
    # Escalation past whole-function rebalancing: one function whose creation
    # load alone exceeds the hot-cold gap cannot be *moved* anywhere useful —
    # it saturates whichever single scale lock owns it. With
    # ``Cluster(cp_fn_split_enabled=True)`` the rebalancer instead *splits*
    # such a function across a shard-set: per-subshard FunctionState slices,
    # each creating on its own scale lock and worker partition (the
    # Archipelago per-service semi-global partitioning idea applied to one
    # function). No paper anchor; operator guidance in docs/operations.md.
    cp_fn_split_max_shards: int = 4    # ceiling on a shard-set's size: each
    #                                    extra subshard adds an autoscale
    #                                    reconcile + a quiesce participant
    cp_fn_split_min_load: float = 4.0  # merge threshold, in heat units
    #                                    (creations charged to the slices,
    #                                    halved each rebalance tick): when a
    #                                    split function's summed slice heat
    #                                    decays below this, it folds back to
    #                                    its home shard
    cp_fn_split_cooldown: float = 10.0  # hysteresis on both edges: a freshly
    #                                    split function stays split at least
    #                                    this long, and a freshly merged one
    #                                    cannot re-split before it elapses —
    #                                    bounds split/merge flapping on a
    #                                    bursty function

    # -- persistence (Redis, AOF fsync always) -------------------------------
    persist_write: float = 0.85e-3     # fsync'd append median (C3 ablation:
    #                                    caps at ~1000 creations/s when sandbox
    #                                    state is persisted on the critical path)
    persist_write_sigma: float = 0.4   # lognormal fsync jitter
    persist_stall_prob: float = 0.002  # AOF-rewrite stalls (Redis): rare but
    persist_stall: float = 0.120       # long WAL holds -> p99 surge at ~500/s
    persist_read: float = 0.2e-3
    persist_replication: float = 0.5e-3  # sync replication to standbys
    persist_group_commit: bool = False  # WAL group commit: writers queued
    #                                    behind an in-flight fsync are absorbed
    #                                    into one batch committed by a single
    #                                    fsync + one replication round (and
    #                                    ``write_many`` bulk-appends the boot
    #                                    registration log in batches). Default
    #                                    OFF: the serialized per-write path is
    #                                    the paper's model and the event-budget
    #                                    pins assert it bit-identically;
    #                                    ``Cluster(persist_group_commit=True)``
    #                                    opts a run in (the 100k-worker boot
    #                                    needs it — see docs/operations.md).
    persist_max_batch: int = 512       # group-commit batch ceiling: one fsync
    #                                    covers at most this many queued writes
    persist_read_per_record: float = 0.0  # per-record cost of a prefix scan
    #                                    (``read_prefix``). 0.0 keeps the
    #                                    legacy flat ``persist_read`` latency
    #                                    (bit-identical); the 100k recovery
    #                                    benches set ~1e-6 s/record so a full
    #                                    ``worker/`` scan is honestly linear.
    cp_checkpoint_period: float = 5.0  # leader snapshot cadence when
    #                                    ``Cluster(cp_checkpoint_enabled=True)``
    #                                    — a compacted ``checkpoint/<epoch>``
    #                                    record written off the critical path
    cp_snapshot_load_per_record: float = 0.4e-6  # bulk snapshot deserialize,
    #                                    per record: ~10× cheaper than a
    #                                    ``cp_cross_shard_op`` replay step —
    #                                    loading a memcpy'd snapshot vs
    #                                    replaying WAL records through the
    #                                    state machine

    # -- worker node ---------------------------------------------------------
    containerd_create_median: float = 0.110  # s; "10-100s of ms" regime
    containerd_create_sigma: float = 0.30
    containerd_kernel_lock: float = 0.052  # serialized per-node kernel time:
    #                                  caps a 93-node cluster at ~1750/s (C2)
    firecracker_create_median: float = 0.040  # p50 snapshot restore (paper §5.2.3)
    firecracker_create_sigma: float = 0.25
    firecracker_kernel_lock: float = 0.010
    netcfg_pool_size: int = 64          # pre-created network configs per node
    netcfg_replenish_period: float = 0.025  # background pre-creation rate
    netcfg_pooled: float = 1.0e-3       # grab a recycled netns+iptables entry
    netcfg_fresh: float = 0.060         # Linux net-stack cost when pool empty
    netcfg_recycle: float = 0.020       # background recycle time
    health_probe_period: float = 0.010  # worker daemon -> sandbox probe
    sandbox_teardown: float = 0.030     # dismantle fs/netns/cgroups (async)
    teardown_drain_grace: float = 0.5   # let dispatched requests finish
    exec_slot_overhead: float = 0.05e-3

    # -- heartbeats / failure detection --------------------------------------
    worker_heartbeat_period: float = 0.5
    worker_heartbeat_timeout: float = 1.5
    worker_hb_cohort_quantum: float = 0.0078125  # = period/64 (2^-7, exact
    #                                    binary float): the grid beat
    #                                    deadlines snap to when the cluster
    #                                    opts into cohort heartbeats
    #                                    (``Cluster(hb_cohort_quantum=...)``,
    #                                    off by default). At 50k workers / 8
    #                                    shards a full cohort's contiguous
    #                                    lock hold is ~6250/64 × 12 µs ≈
    #                                    1.2 ms — bounded latency distortion
    #                                    — while beats collapse ~64× fewer
    #                                    heap events per period. Must divide
    #                                    worker_heartbeat_period exactly and
    #                                    stay far under
    #                                    worker_heartbeat_timeout - 2×period.
    raft_heartbeat_period: float = 0.002
    raft_election_timeout: float = 0.006   # C10: ~10 ms total CP failover
    raft_election_cost: float = 0.001
    cp_recovery_db_fetch: float = 0.002
    cp_recovery_dp_sync: float = 0.001
    systemd_restart_delay: float = 0.8     # detect+restart a crashed process
    dp_resync_cost: float = 0.2            # pull functions+endpoints from CP
    lb_reconfigure: float = 1.0            # keepalived/HAProxy reload (C11: ~2s)
    lb_health_check: float = 0.6           # keepalived failure detection

    # -- misc -----------------------------------------------------------------
    registration_persist_ops: int = 1      # one record write + DP broadcast
    worker_kill_detect: float = 0.05


@dataclass
class KnativeCosts:
    """K8s/Knative mechanism constants (baseline simulator).

    Calibration targets: ≤2 cold starts/s steady-state saturation (C1),
    ~770 ms unloaded function registration (C8), ~400 ms sandbox boot with a
    sequential sidecar + ~500 ms readiness-probe wait (Fig 1), warm-path p50
    ≈7 ms capping at ~1200/s (C5), DP recovery ≈15 s dominated by the Istio
    gateway (C11).
    """

    # -- API server / etcd -----------------------------------------------------
    apiserver_cores: int = 4            # effective parallelism before lock
    #                                     contention (10-core node, Go runtime)
    serialize_per_kb: float = 1.2e-3    # CPU to (de)serialize+validate 1 KB of
    #                                     nested-YAML object state
    object_kb: float = 17.0             # average K8s object size (paper §2.2)
    small_object_kb: float = 4.0        # endpoints/lease-ish updates
    etcd_fsync: float = 2.0e-3          # serialized WAL append+fsync
    etcd_read: float = 0.5e-3
    rpc: float = 0.5e-3                 # controller <-> API server hop
    watch_propagation: float = 5.0e-3   # informer cache lag
    # Asynchronous per-creation API-server work OFF the sequential chain but
    # ON the same CPU: Event objects, status updates, informer resyncs, istio
    # xDS pushes. This is what saturates the API server at ~2 cold starts/s
    # (C1) while unloaded chain latency stays a few hundred ms (Fig 1).
    bg_cpu_per_creation: float = 1.7
    bg_chunk: float = 0.1
    bg_spread: float = 30.0             # the async work trickles in over ~30 s

    # -- controller machinery ----------------------------------------------------
    # Sequential reconcile chain for one sandbox (Deployment -> ReplicaSet ->
    # Pod -> scheduler Binding -> kubelet status -> Endpoints -> SKS/Route),
    # each step = watch wakeup + read + RMW write of a large object.
    creation_chain_ops: int = 10
    controller_qps: float = 20.0        # kube-controller-manager --kube-api-qps
    controller_burst: int = 30
    workqueue_workers: int = 8          # concurrent reconciles per controller
    scheduler_bind: float = 0.008       # ~125 binds/s scheduler throughput
    conflict_window: float = 0.050      # optimistic-concurrency conflict if two
    #                                     RMWs to the same object overlap
    conflict_backoff: float = 0.020
    reconcile_resync: float = 10.0      # periodic resync scan period

    # -- sandbox / pod startup -----------------------------------------------------
    user_container_create: float = 0.200
    sidecar_create: float = 0.200       # queue-proxy, created sequentially
    readiness_probe_wait: float = 0.500  # both containers pass probes (Fig 1)
    kubelet_sync_period: float = 0.100

    # -- warm path -------------------------------------------------------------
    activator_cpu: float = 2.2e-3       # per-request CPU in activator path
    activator_cores: int = 3            # activator replicas: caps warm path at
    #                                     ~1200-1400 req/s (C5)
    queue_proxy_hop: float = 1.5e-3
    istio_hop: float = 2.0e-3
    pod_hop: float = 0.5e-3             # activator -> pod network hop
    lb_hop: float = 0.2e-3

    # -- registration -----------------------------------------------------------
    registration_objects: int = 10      # service, config, revision, route, SKS,
    #                                     deployment, cert, istio VirtualService...
    registration_xds_sync: float = 0.030  # ingress/xDS sync per object
    registration_growth: float = 5.6e-3  # extra CPU per pre-existing function
    #                                     (ingress/route table resync) -> "18 min
    #                                     for 500 functions" (C8)

    # -- failure recovery ----------------------------------------------------------
    pod_restart_delay: float = 2.0      # k8s notices + restarts a component pod
    component_recover_spread: float = 4.0
    istio_gateway_recover: float = 13.0  # slowest component (C11)
    worker_eviction_timeout: float = 5.0

    # -- autoscaler ------------------------------------------------------------
    autoscale_period: float = 2.0
    metrics_report_period: float = 1.0
    scale_up_decision_lag: float = 2.0  # KPA tick + activator stat lag


@dataclass
class CostModel:
    dirigent: DirigentCosts = field(default_factory=DirigentCosts)
    knative: KnativeCosts = field(default_factory=KnativeCosts)


DEFAULT_COSTS = CostModel()


def live_calibrated_candidate(start_log, invoke_walls) -> dict:
    """Turn live-mode measurements into a calibrated ``DirigentCosts``
    candidate: a {field: seconds} dict (only fields the live run actually
    observed) that the bench records next to the modeled defaults so the
    DES and live modes can be cross-checked.

    Mapping (live phase -> modeled constant):

      * warm process-mode creation -> ``firecracker_create_median`` — a
        replica built against a hot executable cache is the snapshot-restore
        analogue: pre-built state, per-instance construction only;
      * cold container-mode creation -> ``containerd_create_median`` — a
        spawned worker paying import + compile is the full container boot;
      * median invoke payload wall -> the workload's real ``exec_time``.

    ``start_log`` is ``LiveBackend.start_log``; ``invoke_walls`` a list of
    per-invoke payload wall seconds."""
    import statistics

    def _med(rows):
        return round(statistics.median(rows), 6) if rows else None

    out = {}
    warm_proc = [r["wall_s"] for r in start_log
                 if r["mode"] == "process" and not r["cold"]]
    cold_cont = [r["wall_s"] for r in start_log
                 if r["mode"] == "container" and r["cold"]]
    if warm_proc:
        out["firecracker_create_median"] = _med(warm_proc)
    if cold_cont:
        out["containerd_create_median"] = _med(cold_cont)
    if invoke_walls:
        out["exec_time_median"] = _med(list(invoke_walls))
    known = {f.name for f in fields(DirigentCosts)}
    out["fields_in_model"] = sorted(k for k in out if k in known)
    return out
