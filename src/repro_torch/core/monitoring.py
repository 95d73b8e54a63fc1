"""Operations & monitoring (paper §4).

"Dirigent components expose global and per-function metrics (e.g., the
number of in-flight requests, queue depth, and number of successful
invocations) via HTTP" — this module renders that endpoint's payload
(Prometheus text exposition format) from live cluster state, plus the
event-log view used to break down end-to-end function latency.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from repro_torch.core.cluster import Cluster


def render_metrics(cluster: "Cluster") -> str:
    """Prometheus-style text exposition of global + per-function metrics."""
    lines: List[str] = []
    c = cluster.collector
    lines.append("# TYPE dirigent_invocations_total counter")
    lines.append(f"dirigent_invocations_total{{status=\"ok\"}} "
                 f"{len(c.completed)}")
    lines.append(f"dirigent_invocations_total{{status=\"failed\"}} "
                 f"{len(c.failed)}")
    lines.append("# TYPE dirigent_sandbox_creations_total counter")
    lines.append(f"dirigent_sandbox_creations_total {c.sandbox_creations}")
    lines.append(f"dirigent_sandbox_teardowns_total {c.sandbox_teardowns}")
    lines.append("# TYPE dirigent_cp_reconciles_total counter")
    lines.append(f"dirigent_cp_reconciles_total {c.reconciles}")
    lines.append("# TYPE dirigent_cp_fn_migrations_total counter")
    lines.append(f"dirigent_cp_fn_migrations_total {c.fn_migrations}")
    lines.append("# TYPE dirigent_cp_fn_splits_total counter")
    lines.append(f"dirigent_cp_fn_splits_total {c.fn_splits}")
    lines.append("# TYPE dirigent_cp_fn_merges_total counter")
    lines.append(f"dirigent_cp_fn_merges_total {c.fn_merges}")
    lines.append("# TYPE dirigent_cp_steals_total counter")
    lines.append(f"dirigent_cp_steals_total {c.steals}")
    lines.append("# TYPE dirigent_cp_steal_probes_total counter")
    lines.append(f"dirigent_cp_steal_probes_total {c.steal_probes}")
    lines.append("# TYPE dirigent_persistent_writes_total counter")
    lines.append(f"dirigent_persistent_writes_total {cluster.store.write_count}")
    store = cluster.store
    lines.append("# TYPE dirigent_store_group_commits_total counter")
    lines.append(f"dirigent_store_group_commits_total {store.group_commits}")
    lines.append("# TYPE dirigent_store_group_commit_batch_size gauge")
    lines.append(f"dirigent_store_group_commit_batch_size "
                 f"{store.last_batch_size}")
    lines.append("# TYPE dirigent_store_checkpoint_epoch gauge")
    lines.append(f"dirigent_store_checkpoint_epoch {store.checkpoint_epoch}")
    # -1 = no checkpoint written yet (or checkpointing disabled)
    ckpt_age = (-1 if store.checkpoint_at is None
                else cluster.env.now - store.checkpoint_at)
    lines.append("# TYPE dirigent_store_checkpoint_age_seconds gauge")
    lines.append(f"dirigent_store_checkpoint_age_seconds {ckpt_age:.6f}")

    leader = cluster.control_plane_leader()
    lines.append("# TYPE dirigent_control_plane_leader gauge")
    lines.append(f"dirigent_control_plane_leader "
                 f"{leader.cp_id if leader else -1}")
    if leader is not None:
        # per-shard CP health: ownership counts, lock queue depth, and the
        # accumulated scale-lock convoy time sharding exists to remove (C1)
        shard_families = [
            ("dirigent_cp_shard_functions", "gauge",
             lambda s: len(s.functions)),
            ("dirigent_cp_shard_workers", "gauge",
             lambda s: len(s.worker_last_hb)),
            ("dirigent_cp_shard_lock_queue", "gauge",
             lambda s: s.scale_lock.queue_len),
            ("dirigent_cp_shard_lock_wait_seconds_total", "counter",
             lambda s: f"{s.lock_wait_s:.6f}"),
            # the rebalancer/steal load signal: recent lock wait + expected
            # wait implied by the current lock queue (docs/operations.md)
            ("dirigent_cp_shard_load", "gauge",
             lambda s: f"{leader.shard_load(s):.6f}"),
        ]
        for family, kind, value in shard_families:
            lines.append(f"# TYPE {family} {kind}")
            for shard in leader.shards:
                lines.append(f"{family}{{shard=\"{shard.shard_id}\"}} "
                             f"{value(shard)}")
        # per-subshard load of split functions (shard-set ownership): how a
        # split function's replicas/creations/heat spread over its set
        split = [(n, st) for n, st in sorted(leader.functions.items())
                 if st.slices is not None]
        if split:
            lines.append("# TYPE dirigent_cp_fn_slice_sandboxes gauge")
            lines.append("# TYPE dirigent_cp_fn_slice_creating gauge")
            lines.append("# TYPE dirigent_cp_fn_slice_heat gauge")
            for name, st in split:
                for k in sorted(st.slices):
                    sl = st.slices[k]
                    tags = f"{{function=\"{name}\",shard=\"{k}\"}}"
                    lines.append(f"dirigent_cp_fn_slice_sandboxes{tags} "
                                 f"{len(sl.sandbox_ids)}")
                    lines.append(f"dirigent_cp_fn_slice_creating{tags} "
                                 f"{sl.creating}")
                    lines.append(f"dirigent_cp_fn_slice_heat{tags} "
                                 f"{sl.heat:.3f}")
        lines.append("# TYPE dirigent_function_ready_sandboxes gauge")
        for name, st in sorted(leader.functions.items()):
            lines.append(f"dirigent_function_ready_sandboxes"
                         f"{{function=\"{name}\"}} {st.ready_count}")
            lines.append(f"dirigent_function_creating"
                         f"{{function=\"{name}\"}} {st.creating}")
    lines.append("# TYPE dirigent_dp_inflight gauge")
    for dp in cluster.data_planes:
        total_inflight = sum(t.inflight for t in dp.tables.values())
        depth = sum(len(t.queue) for t in dp.tables.values())
        lines.append(f"dirigent_dp_inflight{{dp=\"{dp.dp_id}\","
                     f"alive=\"{dp.alive}\"}} {total_inflight}")
        lines.append(f"dirigent_dp_queue_depth{{dp=\"{dp.dp_id}\"}} {depth}")
        # C5 visibility: port-pool occupancy is the warm-path ceiling signal
        lines.append(f"dirigent_dp_ports_in_use{{dp=\"{dp.dp_id}\"}} "
                     f"{dp.ports_in_use}")
        if dp.conn_reuse:
            tags = f"{{dp=\"{dp.dp_id}\"}}"
            lines.append(f"dirigent_dp_conn_open{tags} {dp.conn_open}")
            lines.append(f"dirigent_dp_conn_hits_total{tags} {dp.conn_hits}")
            lines.append(f"dirigent_dp_conn_misses_total{tags} "
                         f"{dp.conn_misses}")
            lines.append(f"dirigent_dp_conn_expired_total{tags} "
                         f"{dp.conn_expired}")
            lines.append(f"dirigent_dp_time_wait_ports{tags} "
                         f"{dp.time_wait_ports}")
        if dp.hedge_after is not None:
            lines.append(f"dirigent_dp_hedged_total{{dp=\"{dp.dp_id}\"}} "
                         f"{dp.hedged}")
    if cluster.fn_dp_table:
        # fn→DP-set steering: which functions are spread, and how wide
        lines.append("# TYPE dirigent_fe_fn_dp_set_size gauge")
        for name, members in sorted(cluster.fn_dp_table.items()):
            lines.append(f"dirigent_fe_fn_dp_set_size"
                         f"{{function=\"{name}\"}} {len(members)}")
    lines.append("# TYPE dirigent_worker_alive gauge")
    alive = sum(1 for w in cluster.workers.values() if w.daemon_alive)
    lines.append(f"dirigent_workers_alive {alive}")
    lines.append(f"dirigent_workers_total {len(cluster.workers)}")
    lb = getattr(cluster, "live_backend", None)
    if lb is not None:
        # live execution mode: real replica population, the shared
        # executable cache's effectiveness (hits = creations that skipped
        # XLA compilation), and wall time spent in real payload execution
        lines.append("# TYPE dirigent_live_replicas gauge")
        lines.append(f"dirigent_live_replicas {lb.replicas_live}")
        lines.append("# TYPE dirigent_live_exec_cache_hits counter")
        lines.append(f"dirigent_live_exec_cache_hits {lb.exec_cache.hits}")
        lines.append("# TYPE dirigent_live_exec_cache_misses counter")
        lines.append(f"dirigent_live_exec_cache_misses "
                     f"{lb.exec_cache.misses}")
        lines.append("# TYPE dirigent_live_invoke_seconds counter")
        lines.append(f"dirigent_live_invoke_seconds "
                     f"{lb.invoke_seconds_total:.6f}")
        lines.append("# TYPE dirigent_live_invocations_total counter")
        lines.append(f"dirigent_live_invocations_total {lb.invokes}")
        lines.append("# TYPE dirigent_live_tokens_total counter")
        lines.append(f"dirigent_live_tokens_total {lb.tokens_total}")
    return "\n".join(lines) + "\n"


def render_event_log(cluster: "Cluster", since: float = 0.0) -> str:
    """Human-readable cluster event log (leader elections, failures,
    recoveries, evictions) — the debugging/latency-breakdown feed."""
    out = []
    for t, kind, detail in cluster.collector.events:
        if t >= since:
            out.append(f"{t:12.4f}s  {kind:<24} {detail}")
    return "\n".join(out) + ("\n" if out else "")
