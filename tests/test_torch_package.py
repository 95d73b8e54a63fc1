"""The port as a package: its framework-neutral copies are the originals,
it imports nothing of JAX or of ``repro``, its entry points refuse to run
on the CPU unasked, and the copied orchestrator keeps its determinism pin.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
REF, PORT = os.path.join(SRC, "repro"), os.path.join(SRC, "repro_torch")

COPIED = (
    [f"simcore/{n}.py" for n in ("__init__", "engine", "sanitize")]
    + [f"core/{n}.py" for n in (
        "__init__", "abstractions", "autoscaler", "baseline_knative",
        "cluster", "control_plane", "costmodel", "data_plane",
        "leader_election", "metrics", "monitoring", "persistence",
        "placement", "policies", "request", "worker")]
    + [f"analysis/{n}.py" for n in ("__init__", "lint", "rules")]
    + [f"configs/{n}.py" for n in (
        "__init__", "base", "arctic_480b", "glm4_9b", "granite_34b",
        "kimi_k2", "qwen2_vl_72b", "qwen3_32b", "rwkv6_7b", "smollm_360m",
        "whisper_small", "zamba2_2p7b")])


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


# the benches' DES helpers: the port's copy beside its original
BENCH_COPIES = {"benchmarks/torch_common.py": "benchmarks/common.py"}


@pytest.mark.parametrize("rel", COPIED + list(BENCH_COPIES))
def test_copied_file_equals_original_up_to_package_name(rel):
    """core/, simcore/, analysis/ and configs/ are verbatim copies, and so
    is benchmarks/torch_common.py of benchmarks/common.py: only
    ``repro.`` /
    ``repro/`` became ``repro_torch.`` / ``repro_torch/``. Read as text —
    nothing of ``repro`` is imported here."""
    if rel in BENCH_COPIES:
        orig, copy = (os.path.join(ROOT, p) for p in (BENCH_COPIES[rel], rel))
    else:
        orig, copy = os.path.join(REF, rel), os.path.join(PORT, rel)
    want = re.sub(r"\brepro([./])", r"repro_torch\1", _read(orig))
    assert _read(copy) == want


def test_every_copied_directory_is_listed():
    for sub in ("simcore", "core", "analysis", "configs"):
        have = {f"{sub}/{n}" for n in os.listdir(os.path.join(PORT, sub))
                if n.endswith(".py")}
        assert have == {r for r in COPIED if r.startswith(sub + "/")}


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter: import repro_torch and every submodule (and
    load chip_smoke.py's source as a module); neither ``jax`` nor any
    ``repro.*`` module may have been pulled in."""
    code = r"""
import importlib, importlib.util, os, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[1], "chip_smoke.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "repro" or n.startswith("repro.") or n == "msgpack")
assert not bad, bad
need = {"repro_torch.kernels.ops", "repro_torch.kernels.build",
        "repro_torch.models.transformer", "repro_torch.serving.engine",
        "repro_torch.serving.exec_cache", "repro_torch.live.backend",
        "repro_torch.core.cluster", "repro_torch.simcore.engine",
        "repro_torch.configs.smollm_360m", "repro_torch.convert",
        "repro_torch.models.rwkv", "repro_torch.models.ssm",
        "repro_torch.kernels.rwkv6_chunk", "repro_torch.kernels.ssd_chunk",
        "repro_torch.kernels.chunked", "repro_torch.models.moe",
        "repro_torch.live.container", "repro_torch.analysis.lint",
        "repro_torch.core.baseline_knative", "repro_torch.models.whisper",
        "repro_torch.train.optimizer", "repro_torch.train.compress",
        "repro_torch.train.data", "repro_torch.train.train_step",
        "repro_torch.train.checkpoint", "repro_torch.train.msgpack_codec",
        "repro_torch.launch.train", "repro_torch.launch.serve",
        "repro_torch.launch.mesh", "repro_torch.models.sharding",
        "repro_torch.models.distributed_attention",
        "repro_torch.launch.steps", "repro_torch.launch.dryrun",
        "repro_torch.launch.roofline", "repro_torch.launch.collectives"}
assert need <= set(names), need - set(names)
from repro_torch.kernels import build
assert build._lib is None            # nothing was built or loaded on import
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_name_no_jax_import():
    """Belt and braces for the subprocess test: no source line of the port
    (its package, chip_smoke.py, its examples, its benches) imports jax or
    repro."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += [os.path.join(ROOT, "examples", n)
              for n in os.listdir(os.path.join(ROOT, "examples"))
              if n.endswith("_torch.py")]
    benches = [os.path.join(ROOT, "benchmarks", n)
               for n in os.listdir(os.path.join(ROOT, "benchmarks"))
               if n.startswith("torch_") and n.endswith(".py")]
    assert len(benches) >= 3
    paths += benches
    for dirpath, _, names in os.walk(PORT):
        paths += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(paths) > 40
    for p in paths:
        assert not pat.search(_read(p)), p


KERNELS = ["decode_attention", "flash_attention", "rwkv6_chunk", "ssd_chunk",
           "wkv6_decode"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_sources_are_plain_cuda(name):
    """Every kernel exists as hand-written CUDA C++ with a plain C
    interface: no PyTorch headers (those turn a seconds-long build into
    minutes), no library kernels, and a note naming the TPU kernel it
    replaces (the WKV6 decode step, which has none: the ``jnp`` step the
    reference decodes with)."""
    csrc = os.path.join(PORT, "kernels", "csrc")
    entry = {"rwkv6_chunk": "repro_wkv6_chunk",
             "ssd_chunk": "repro_ssd_chunk"}.get(name, f"repro_{name}")
    text = _read(os.path.join(csrc, name + ".cu"))
    assert "__global__" in text and f'extern "C" int {entry}' in text
    assert "torch/" not in text and "ATen" not in text
    assert "cublas" not in text.lower() and "cutlass" not in text.lower()
    replaced = {"wkv6_decode": "chunked"}.get(name, name)
    assert f"src/repro/kernels/{replaced}.py" in text  # names what it replaces


def test_default_device_raises_without_cuda():
    """Entry points default to the GPU and do not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    from repro_torch.compat import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.live import LiveBackend, LiveFunctionSpec
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        Replica(cfg, exec_cache=ExecutableCache())
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveBackend(default_spec=LiveFunctionSpec(cfg=cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecutableCache().warm(cfg, ShapeSpec("live", 16, 2, "decode"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _meta_call(name):
    """The kernel's wrapper and a call of it on 'meta' tensors."""
    import importlib

    fn = getattr(importlib.import_module(f"repro_torch.kernels.{name}"), {
        "rwkv6_chunk": "wkv6", "ssd_chunk": "ssd"}.get(name, name))

    def meta(*shape):
        return torch.empty(*shape, device="meta")

    if name == "flash_attention":
        return fn, lambda: fn(meta(1, 4, 6, 32), meta(1, 4, 2, 32),
                              meta(1, 4, 2, 32))
    if name == "decode_attention":
        return fn, lambda: fn(meta(1, 1, 6, 32), meta(1, 4, 2, 32),
                              meta(1, 4, 2, 32), 3)
    if name == "rwkv6_chunk":
        r = meta(1, 16, 2, 16)
        return fn, lambda: fn(r, r, r, r, meta(2, 16), chunk=16)
    if name == "wkv6_decode":
        r = meta(1, 1, 2, 16)
        return fn, lambda: fn(r, r, r, r, meta(2, 16), meta(1, 2, 16, 16), 3)
    x, bc = meta(1, 16, 2, 8), meta(1, 16, 2, 16)
    return fn, lambda: fn(x, meta(1, 16, 2), meta(2), bc, bc, meta(2),
                          chunk=16)


@pytest.mark.parametrize("name", KERNELS)
def test_only_a_cpu_tensor_takes_the_plain_path(name):
    """The wrappers take the plain version for a CPU tensor and for nothing
    else: any other device launches the kernel or raises, with no ``try``
    that falls back. A 'meta' tensor stands in for 'not on the CPU' here."""
    import inspect

    from repro_torch.kernels import ops

    fn, call = _meta_call(name)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no kernel for device"):
        call()
    assert ops.launch_counts() == before
    src = inspect.getsource(fn)
    assert "try:" not in src and "except" not in src


def test_event_budget_pin_holds_on_the_copied_cluster():
    """The first pin of tests/test_event_budget.py (8,525 events for the
    fixed 50-worker cell), reproduced on the port's copy of the
    orchestrator: the copy is event-for-event the original."""
    from repro_torch.core import Cluster, Function, ScalingConfig
    from repro_torch.simcore import Environment

    def run():
        env = Environment(seed=2024)
        cl = Cluster(env, n_workers=50, runtime="firecracker")
        cl.start()
        leader = cl.control_plane_leader()
        names = [f"f{i}" for i in range(40)]
        for n in names:
            leader.install_function(Function(
                name=n, image_url="img://budget", port=80,
                scaling=ScalingConfig(stable_window=1.0, panic_window=1.0,
                                      scale_to_zero_grace=0.2)))
            for dp in cl.data_planes:
                dp.sync_functions([n])

        def client(env):
            for _ in range(5):
                for n in names:
                    cl.invoke(n, exec_time=0.05)
                    yield env.timeout(1.0 / 200.0)
                yield env.timeout(2.5)

        env.process(client(env), name="budget-client")
        env.run(until=16.0)
        return env.events_processed, cl.collector.sandbox_creations

    events, creations = run()
    assert (events, creations) == run()
    assert creations > 0
    assert events == 8_525


def _strip_suppressions(source):
    return re.sub(r"#\s*simlint:\s*ok\([^)]*\).*", "", source)


def test_copied_linter_gives_the_original_findings():
    """The copied simlint on the port's core/ and simcore/ finds what the
    original finds on repro's: on the trees as they stand (its default
    paths, now the port's), and on every file with its suppressions
    stripped, so that every rule has findings to agree on."""
    from repro.analysis import DEFAULT_PATHS as ref_paths
    from repro.analysis import lint_paths as ref_lint_paths
    from repro.analysis import lint_source as ref_lint_source
    from repro_torch.analysis import DEFAULT_PATHS, lint_paths, lint_source

    assert DEFAULT_PATHS == tuple(p.replace("src/repro/", "src/repro_torch/")
                                  for p in ref_paths)

    def key(findings):
        """(path below the package, line, rule, message) of each finding"""
        return [(f.path.replace(PORT, "").replace(REF, ""), f.line, f.rule,
                 f.message) for f in findings]

    assert key(lint_paths([os.path.join(ROOT, p) for p in DEFAULT_PATHS])) \
        == key(ref_lint_paths([os.path.join(ROOT, p) for p in ref_paths]))
    rules_seen = set()
    for sub in ("core", "simcore"):
        for name in sorted(os.listdir(os.path.join(REF, sub))):
            if not name.endswith(".py"):
                continue
            rel = f"{sub}/{name}"
            want = ref_lint_source(
                _strip_suppressions(_read(os.path.join(REF, rel))), rel)
            got = lint_source(
                _strip_suppressions(_read(os.path.join(PORT, rel))), rel)
            assert [(f.line, f.rule, f.message) for f in got] == \
                [(f.line, f.rule, f.message) for f in want], rel
            rules_seen |= {f.rule for f in want}
    # the rules the stripped trees leave quiet, on a snippet of their own
    snippet = (
        "import random\n"
        "def f(self, env, names):\n"
        "    x = hash(names) % 4\n"
        "    random.random()\n"
        "    for n in set(names):\n"
        "        env.log(n)\n"
        "    yield self.src.scale_lock.acquire()\n"
        "    yield self.dst.scale_lock.acquire()\n")
    got, want = lint_source(snippet, "s.py"), ref_lint_source(snippet, "s.py")
    assert key(got) == key(want)
    rules_seen |= {f.rule for f in want}
    assert {"builtin-hash", "global-rng", "set-iteration", "lock-order",
            "dict-iteration", "held-lock-timeout",
            "wall-clock"} <= rules_seen, rules_seen


def test_copied_knative_baseline_replays_the_original_trace():
    """The copied KnativeCluster, driven on one seed with a burst of cold
    and warm invocations, gives the original's event count and every
    invocation's timeline."""
    from repro.core import Function as RFunction
    from repro.core import ScalingConfig as RScaling
    from repro.core.baseline_knative import KnativeCluster as RKnative
    from repro.simcore import Environment as REnv
    from repro_torch.core import Function, ScalingConfig
    from repro_torch.core.baseline_knative import KnativeCluster
    from repro_torch.simcore import Environment

    def run(env_cls, cluster_cls, fn_cls, scaling_cls):
        env = env_cls(seed=11)
        kn = cluster_cls(env, n_workers=8)
        for i in range(3):
            kn.register_sync(fn_cls(name=f"f{i}", image_url="img://kn",
                                    port=80, scaling=scaling_cls()))
        invs = []

        def client(env):
            for r in range(4):
                for i in range(3):
                    invs.append(kn.invoke(f"f{i}", exec_time=0.05))
                    yield env.timeout(0.01)
                yield env.timeout(1.0)

        env.process(client(env), name="kn-client")
        env.run(until=30.0)
        return env.events_processed, [
            (i.inv_id, i.function_name, i.t_done, i.failed, i.cold)
            for i in invs]

    events, trace = run(Environment, KnativeCluster, Function, ScalingConfig)
    assert sum(1 for t in trace if t[2] > 0 and not t[3]) == 12
    assert (events, trace) == run(REnv, RKnative, RFunction, RScaling)
