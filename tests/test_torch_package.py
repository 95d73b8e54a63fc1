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
        "__init__", "abstractions", "autoscaler", "cluster", "control_plane",
        "costmodel", "data_plane", "leader_election", "metrics", "monitoring",
        "persistence", "placement", "policies", "request", "worker")]
    + [f"configs/{n}.py" for n in (
        "__init__", "base", "arctic_480b", "glm4_9b", "granite_34b",
        "kimi_k2", "qwen2_vl_72b", "qwen3_32b", "rwkv6_7b", "smollm_360m",
        "whisper_small", "zamba2_2p7b")])


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_equals_original_up_to_package_name(rel):
    """core/, simcore/ and configs/ are verbatim copies: only ``repro.`` /
    ``repro/`` became ``repro_torch.`` / ``repro_torch/``. Read as text —
    nothing of ``repro`` is imported here."""
    want = re.sub(r"\brepro([./])", r"repro_torch\1",
                  _read(os.path.join(REF, rel)))
    assert _read(os.path.join(PORT, rel)) == want


def test_every_copied_directory_is_listed():
    for sub in ("simcore", "core", "configs"):
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
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
need = {"repro_torch.kernels.ops", "repro_torch.kernels.build",
        "repro_torch.models.transformer", "repro_torch.serving.engine",
        "repro_torch.serving.exec_cache", "repro_torch.live.backend",
        "repro_torch.core.cluster", "repro_torch.simcore.engine",
        "repro_torch.configs.smollm_360m", "repro_torch.convert"}
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
    imports jax or repro."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        paths += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(paths) > 40
    for p in paths:
        assert not pat.search(_read(p)), p


def test_kernel_sources_are_plain_cuda():
    """Both kernels exist as hand-written CUDA C++ with a plain C interface:
    no PyTorch headers (those turn a seconds-long build into minutes)."""
    csrc = os.path.join(PORT, "kernels", "csrc")
    for name, entry in (("decode_attention.cu", "repro_decode_attention"),
                        ("flash_attention.cu", "repro_flash_attention")):
        text = _read(os.path.join(csrc, name))
        assert "__global__" in text and f'extern "C" int {entry}' in text
        assert "torch/" not in text and "ATen" not in text
        assert "src/repro/kernels/" in text      # names what it replaces


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


def test_only_a_cpu_tensor_takes_the_plain_path():
    """The wrappers take the plain version for a CPU tensor and for nothing
    else: any other device launches the kernel or raises, with no ``try``
    that falls back. A 'meta' tensor stands in for 'not on the CPU' here."""
    import inspect

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.empty(1, 4, 6, 32, device="meta")
    kv = torch.empty(1, 4, 2, 32, device="meta")
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no kernel for device"):
        flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        decode_attention(q[:, :1], kv, kv, 3)
    assert ops.launch_counts() == before
    for fn in (decode_attention, flash_attention):
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
