"""Live execution mode of the port (process mode), mirroring
tests/test_live.py: batcher-under-churn semantics, LiveBackend hooks, and
the DES invoke path of the port's own ``Cluster`` with real payloads, all on
the CPU (``device="cpu"``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Cluster  # noqa: E402
from repro_torch.core.abstractions import Sandbox  # noqa: E402
from repro_torch.core.monitoring import render_metrics  # noqa: E402
from repro_torch.core.request import LiveRequest  # noqa: E402
from repro_torch.live import LiveBackend, LiveFunctionSpec, LiveTicket  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, Replica  # noqa: E402
from repro_torch.serving.exec_cache import ExecutableCache  # noqa: E402
from repro_torch.simcore import Environment  # noqa: E402

TINY = get_config("smollm-360m").reduced(
    n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128)


def _sandbox(sid: int, fn: str = "lf0") -> Sandbox:
    return Sandbox(sandbox_id=sid, function_name=fn,
                   ip=(10, 0, 0, 1), port=80, worker_id=0)


def _backend(max_slots: int = 4) -> LiveBackend:
    spec = LiveFunctionSpec(cfg=TINY, mode="process", max_seq=64,
                            max_slots=max_slots, default_max_new=4)
    return LiveBackend(default_spec=spec, exec_cache=ExecutableCache(),
                       device="cpu")


# -- ContinuousBatcher under churn ------------------------------------------------

@pytest.fixture(scope="module")
def shared_replica():
    return Replica(TINY, max_seq=64, exec_cache=ExecutableCache(),
                   device="cpu")


def test_slot_admission_mid_flight_under_churn(shared_replica):
    """Admit into slots freed by finished requests while others are still
    decoding; every generation must match its solo run."""
    cb = ContinuousBatcher(shared_replica, max_slots=2)
    outs = {}
    prompts = {0: [1, 2, 3], 1: [4, 5], 2: [6, 7, 8], 3: [9]}
    rids = {cb.add_request(prompts[0], max_new=6): 0,
            cb.add_request(prompts[1], max_new=3): 1}
    pending = [2, 3]
    for _ in range(200):
        done = cb.step()
        for rid in done:
            outs[rids[rid]] = cb.finished[rid]
        while pending and cb.free_slots:      # churn: refill freed slots
            k = pending.pop(0)
            rids[cb.add_request(prompts[k],
                                max_new=6 if k == 2 else 2)] = k
        if len(outs) == 4:
            break
    assert len(outs) == 4
    solo = {k: shared_replica.generate(
        p, max_new_tokens={0: 6, 1: 3, 2: 6, 3: 2}[k])
        for k, p in prompts.items()}
    assert outs == solo


def test_per_slot_cache_length_isolation(shared_replica):
    """Slots advance their cache lengths independently: a long-prompt slot
    must not bleed position state into a short-prompt neighbour."""
    cb = ContinuousBatcher(shared_replica, max_slots=3)
    long_rid = cb.add_request([1, 2, 3, 4, 5, 6, 7, 8], max_new=2)
    for _ in range(3):
        cb.step()
    short_rid = cb.add_request([9], max_new=2)
    lens = {s.request_id: s.length for s in cb.slots if s.active}
    assert lens[long_rid] > lens[short_rid] == 0
    cb.run_until_done()
    assert cb.finished[long_rid] == shared_replica.generate(
        [1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    assert cb.finished[short_rid] == shared_replica.generate(
        [9], max_new_tokens=2)


def test_teardown_drain_finishes_in_slot_requests():
    lb = _backend()
    lb.create_hook(_sandbox(1))
    t1 = lb.admit(1, LiveRequest(prompt=[1, 2], max_new_tokens=3))
    t2 = lb.admit(1, LiveRequest(prompt=[3], max_new_tokens=2))
    assert isinstance(t1, LiveTicket) and t2.admit_peers == 1
    lb.teardown_hook(1, True)
    assert lb.replicas_live == 0
    for t in (t1, t2):
        req = lb.collect(t)
        assert not req.failed and len(req.tokens) > 0


def test_teardown_fail_fails_in_slot_requests():
    lb = _backend()
    lb.create_hook(_sandbox(1))
    t1 = lb.admit(1, LiveRequest(prompt=[1, 2], max_new_tokens=3))
    lb.teardown_hook(1, False)
    req = lb.collect(t1)
    assert req.failed and "fail" in req.failure_reason
    assert req.tokens is None


def test_batcher_abort_discards_partials(shared_replica):
    cb = ContinuousBatcher(shared_replica, max_slots=2)
    rid = cb.add_request([1, 2, 3], max_new=8)
    for _ in range(5):
        cb.step()
    killed = cb.abort()
    assert killed == [rid]
    assert rid not in cb.finished
    assert all(not s.active for s in cb.slots)


# -- backend hooks and counters -----------------------------------------------------

def test_create_hook_logs_cold_then_warm_and_seeds_by_sandbox_id():
    lb = _backend()
    lb.create_hook(_sandbox(1))
    lb.create_hook(_sandbox(2))
    assert [r["cold"] for r in lb.start_log] == [True, False]
    assert all(r["mode"] == "process" and r["wall_s"] > 0
               for r in lb.start_log)
    assert lb.replicas_live == 2
    assert lb.cache_stats()["compiled_executables"] == 1
    # weights are drawn from the sandbox id, exactly as a fresh Replica's
    req = lb.collect(lb.admit(2, LiveRequest(prompt=[1, 2, 3],
                                             max_new_tokens=5)))
    solo = Replica(TINY, rng_seed=2, max_seq=64, exec_cache=lb.exec_cache,
                   device="cpu").generate([1, 2, 3], max_new_tokens=5)
    assert req.tokens == solo and req.batched_with == 0
    assert lb.invokes == 1 and lb.tokens_total == 5
    assert lb.invoke_seconds_total == req.wall_s > 0
    lb.close()
    assert lb.replicas_live == 0 and lb.teardowns == 2


def test_admit_to_missing_sandbox_and_unknown_function_raise():
    lb = _backend()
    with pytest.raises(RuntimeError):
        lb.admit(99, LiveRequest(prompt=[1]))
    bare = LiveBackend(exec_cache=ExecutableCache(), device="cpu")
    with pytest.raises(KeyError):
        bare.create_hook(_sandbox(1, fn="nope"))


def test_container_mode_names_its_roadmap_item():
    spec = LiveFunctionSpec(cfg=TINY, mode="container")
    lb = LiveBackend(default_spec=spec, exec_cache=ExecutableCache(),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="container mode"):
        lb.create_hook(_sandbox(1))
    assert lb.replicas_live == 0


def test_worker_kill_sandbox_calls_teardown_hook():
    from repro_torch.core.abstractions import WorkerNodeInfo
    from repro_torch.core.costmodel import DEFAULT_COSTS
    from repro_torch.core.worker import WorkerDaemon

    env = Environment(seed=1)
    calls = []
    w = WorkerDaemon(env, WorkerNodeInfo(0, "w0", (10, 0, 0, 1), 9000),
                     DEFAULT_COSTS.dirigent,
                     teardown_hook=lambda sid, drain: calls.append(
                         (sid, drain)))
    sb = _sandbox(7)
    env.process(w.create_sandbox(sb), name="create")
    env.run(until=5.0)
    assert sb.sandbox_id in w.sandboxes
    env.process(w.kill_sandbox(7), name="kill")
    env.run(until=10.0)
    assert calls == [(7, True)]               # graceful: drain semantics


def test_worker_fail_node_calls_teardown_hook_no_drain():
    from repro_torch.core.abstractions import WorkerNodeInfo
    from repro_torch.core.costmodel import DEFAULT_COSTS
    from repro_torch.core.worker import WorkerDaemon

    env = Environment(seed=1)
    calls = []
    w = WorkerDaemon(env, WorkerNodeInfo(0, "w0", (10, 0, 0, 1), 9000),
                     DEFAULT_COSTS.dirigent,
                     teardown_hook=lambda sid, drain: calls.append(
                         (sid, drain)))
    for sid in (1, 2):
        env.process(w.create_sandbox(_sandbox(sid)), name=f"c{sid}")
    env.run(until=5.0)
    w.fail_node()
    assert sorted(calls) == [(1, False), (2, False)]
    assert not w.sandboxes


# -- end-to-end live invoke path ------------------------------------------------------

def _live_cluster(env, lb, n_workers=4):
    from repro_torch.core import Function, ScalingConfig
    cl = Cluster(env, n_workers=n_workers, runtime="firecracker",
                 live_backend=lb, sandbox_concurrency=4)
    cl.start()
    leader = cl.control_plane_leader()
    fn = Function(name="lf0", image_url="img://t", port=80,
                  scaling=ScalingConfig(stable_window=1.0, panic_window=1.0,
                                        scale_to_zero_grace=0.2))
    leader.install_function(fn)
    for dp in cl.data_planes:
        dp.sync_functions(["lf0"])
    return cl


def test_live_invoke_end_to_end_with_batching():
    env = Environment(seed=3)
    lb = _backend()
    cl = _live_cluster(env, lb)
    invs = []

    def client(env):
        for i in range(5):
            invs.append(cl.invoke("lf0", 0.01, request=LiveRequest(
                prompt=[1, 2, 3], max_new_tokens=4)))
            yield env.timeout(0.001)

    env.process(client(env), name="client")
    env.run(until=30.0)
    done = [i for i in invs if i.t_done > 0 and not i.failed]
    assert len(done) == 5
    # every completed invocation executed a real payload
    assert all(i.request.tokens is not None and len(i.request.tokens) == 4
               for i in done)
    # identical requests to one replica produce identical tokens
    assert len({tuple(i.request.tokens) for i in done}) == 1
    # sim-concurrent requests shared decode steps in the batcher
    assert lb.batched_invokes > 0
    # wall time was billed to the sim clock: exec span covers payload wall
    assert all(i.t_done > i.t_exec_start for i in done)
    # creations were warm after the first (shared warm-state cache)
    colds = [r["cold"] for r in lb.start_log]
    assert colds.count(True) == 1


def test_live_metrics_rendered():
    env = Environment(seed=4)
    lb = _backend()
    cl = _live_cluster(env, lb)

    def client(env):
        cl.invoke("lf0", 0.01,
                  request=LiveRequest(prompt=[5], max_new_tokens=2))
        yield env.timeout(0.0)

    env.process(client(env), name="client")
    env.run(until=10.0)
    m = render_metrics(cl)
    for name in ("dirigent_live_replicas", "dirigent_live_exec_cache_hits",
                 "dirigent_live_exec_cache_misses",
                 "dirigent_live_invoke_seconds", "dirigent_live_tokens_total"):
        assert name in m


def test_des_only_cluster_renders_no_live_metrics():
    env = Environment(seed=5)
    cl = Cluster(env, n_workers=2)
    cl.start()
    env.run(until=1.0)
    assert "dirigent_live_" not in render_metrics(cl)


def test_scale_to_zero_reclaims_live_replicas():
    env = Environment(seed=6)
    lb = _backend()
    cl = _live_cluster(env, lb)

    def client(env):
        cl.invoke("lf0", 0.01,
                  request=LiveRequest(prompt=[1], max_new_tokens=2))
        yield env.timeout(0.0)

    env.process(client(env), name="client")
    env.run(until=60.0)                       # past scale-to-zero grace
    assert lb.replicas_live == 0              # teardown_hook reclaimed
    assert lb.teardowns >= 1
