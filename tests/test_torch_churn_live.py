"""The port's live churn bench (``benchmarks/torch_churn_live.py``) against
the reference's live cells (``benchmarks/churn_scale.py``), at the
reference's reduced width on the CPU: the same keys and traffic, every
invocation done with real tokens, one cold creation; its smoke run in a
fresh interpreter loads neither JAX nor ``repro`` and writes only its own
file; without a device it refuses to run.
"""
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks", "torch_churn_live.py")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("torch_churn_live", BENCH)

# what the port's cells record beside the reference's keys
ADDED_GRID = {"device", "width", "create_errors", "leaked_replicas",
              "bad_tokens", "executed", "peak_replicas", "warm_steps",
              "decode_steps", "creates", "cold_build_ms_median",
              "cold_warmup_ms_median", "cold_capture_ms_median",
              "warm_build_ms_median", "warm_warmup_ms_median",
              "warm_capture_ms_median", "solo_checks", "solo_steps"}
ADDED_COLD_WARM = ADDED_GRID - {"bad_tokens", "executed", "peak_replicas",
                                "solo_checks", "solo_steps"}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    return _load("churn_scale", os.path.join(ROOT, "benchmarks",
                                             "churn_scale.py"))


def test_grid_point_matches_the_references_ci_cell(ref):
    """The reference's CI leg (``run_live_smoke``'s real-invoke cell):
    4 workers, 20 requests a second for 1 s over 2 functions."""
    want = ref.live_grid_point(4, 20.0, 1.0, n_functions=2)
    got = port.live_grid_point(4, 20.0, 1.0, n_functions=2, width="reduced",
                               device="cpu")
    assert set(got) - set(want) == ADDED_GRID
    assert set(want) <= set(got)
    assert got["total"] == want["total"] == 20
    for cell in (got, want):
        assert cell["done"] == cell["total"]
        assert cell["cold_creates"] == 1
        assert cell["tokens"] == 8 * cell["done"]
    # the reference asserts executed == done inside its cell
    assert got["executed"] == got["done"]
    assert got["bad_tokens"] == 0 and got["leaked_replicas"] == 0
    assert got["create_errors"] == []
    assert got["width"] == "reduced" and got["device"]["device"] == "cpu"
    assert len(got["_start_log"]) == got["creations"] == len(got["creates"])
    assert got["decode_steps"] > 0 and got["warm_steps"] > 0
    # the first and the last done invocations, decoded again alone
    assert len(got["solo_checks"]) == 2 and got["solo_steps"] > 0
    assert all(r["equal"] for r in got["solo_checks"])
    assert port.failures(got) == []


def test_cold_warm_point_splits_where_the_reference_does(ref):
    want = ref.live_cold_warm_point("process")
    got = port.live_cold_warm_point("process", width="reduced",
                                    device="cpu")
    assert set(got) - set(want) == ADDED_COLD_WARM
    assert set(want) <= set(got)
    assert got["n_warm"] == want["n_warm"] == 4
    assert [r["cold"] for r in got["creates"]] == [True] + [False] * 4
    for r in got["creates"]:
        # the CPU warms the step up and captures nothing
        assert r["build_s"] > 0 and r["warm_s"] > 0 and r["capture_s"] is None
        # the timed parts lie inside the creation's wall time
        assert r["build_s"] + r["warm_s"] <= r["wall_s"] + 1e-5
    assert got["exec_cache"]["misses"] == want["exec_cache"]["misses"] == 1
    assert got["leaked_replicas"] == 0 and port.failures(got) == []


def test_creations_are_timed_on_the_ports_own_path(monkeypatch):
    """The bench reads the split ``LiveBackend.create_hook`` records of the
    sandbox it builds: a delay put into the replica's construction, before
    its warm-up, shows in every creation's ``build_s``."""
    from repro_torch.serving import engine

    real, made = engine.Replica.__init__, []

    def slow(self, *a, **kw):
        made.append(1)
        time.sleep(0.05)
        real(self, *a, **kw)

    monkeypatch.setattr(engine.Replica, "__init__", slow)
    got = port.live_cold_warm_point("process", width="reduced",
                                    device="cpu")
    assert len(made) == len(got["creates"]) == 5
    for r in got["creates"]:
        assert r["build_s"] >= 0.05 and r["warm_s"] > 0
        assert r["wall_s"] >= 0.05 + r["warm_s"]


def test_smoke_section_candidate_has_the_references_fields(monkeypatch):
    """``live_grid_section(smoke=True)``: process cold/warm, one grid cell,
    the Azure slice; its calibrated candidate is what the reference's own
    ``live_calibrated_candidate`` makes of the same measurements."""
    from repro_torch.core import costmodel

    seen = {}
    real = costmodel.live_calibrated_candidate

    def spy(start_log, invoke_walls):
        seen["args"] = (list(start_log), list(invoke_walls))
        return real(start_log, invoke_walls)

    monkeypatch.setattr(costmodel, "live_calibrated_candidate", spy)
    sec = port.live_grid_section(smoke=True, width="reduced", device="cpu")
    assert [c["mode"] for c in sec["cold_warm"]] == ["process"]
    assert [(c["workers"], c["rate"]) for c in sec["grid"]] == [(8, 50.0)]
    az = sec["azure_slice"]
    assert az["done"] == az["total"] == az["real_payloads_executed"]
    assert az["workers"] == 16 and az["n_functions"] == 10
    cand = sec["costs_candidate"]
    assert set(cand) == {"firecracker_create_median", "exec_time_median",
                         "fields_in_model"}
    assert cand["fields_in_model"] == ["firecracker_create_median"]
    pytest.importorskip("jax")
    from repro.core.costmodel import live_calibrated_candidate as ref_cand
    assert ref_cand(*seen["args"]) == cand
    for cell in sec["cold_warm"] + sec["grid"] + [az]:
        assert port.failures(cell) == []


def _tree_digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_smoke_cli_writes_its_own_file_without_jax_or_repro(tmp_path):
    """``--smoke --width reduced --device cpu`` in a fresh interpreter from
    an empty directory: exit 0, one file written (``--out``), nothing of
    JAX or ``repro`` loaded, ``BENCH_churn.json`` untouched."""
    bench_churn = os.path.join(ROOT, "BENCH_churn.json")
    digest = _tree_digest(bench_churn)
    out = tmp_path / "live.json"
    code = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("torch_churn_live", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
rc = mod.main(["--smoke", "--width", "reduced", "--device", "cpu",
               "--out", sys.argv[2]])
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "repro" or n.startswith("repro."))
print(json.dumps({"rc": rc, "bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, BENCH, str(out)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "bad": []}
    assert sorted(os.listdir(tmp_path)) == ["live.json"]
    assert _tree_digest(bench_churn) == digest
    data = json.loads(out.read_text())
    assert data["failures"] == []
    assert data["meta"] == {"bench": "torch_churn_live", "smoke": True,
                            "width": "reduced"}
    sec = data["live_grid"]
    assert {"provenance", "cold_warm", "grid", "azure_slice",
            "costs_candidate"} <= set(sec)
    assert sec["provenance"]["torch"] == torch.__version__
    real = data["live_smoke"]["real_invoke"]
    assert real["done"] == real["total"] == 20 and real["tokens"] == 160


@pytest.mark.parametrize("fault,cell", [
    ("create", {"create_errors": ["RuntimeError('x')"]}),
    ("undone", {"done": 19, "total": 20}),
    ("tokens", {"bad_tokens": 1}),
    ("leak", {"leaked_replicas": 1}),
    ("solo", {"solo_checks": [{"sandbox_id": 3, "inv_id": 0,
                               "equal": False}]}),
    ("uncaptured", {"device": {"device": "cuda:0"},
                    "creates": [{"captured": True}, {"captured": False}]}),
])
def test_failures_name_each_fault(fault, cell):
    base = {"done": 20, "total": 20, "create_errors": [], "bad_tokens": 0,
            "leaked_replicas": 0, "device": {"device": "cpu"},
            "creates": [{"captured": False}]}
    assert port.failures(base) == []
    assert len(port.failures({**base, **cell})) == 1


def test_no_device_means_the_gpu_and_raises_without_one(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.live_grid_point(4, 20.0, 1.0, n_functions=2, width="reduced")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.live_cold_warm_point("process", width="reduced")
    out = tmp_path / "x.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(["--smoke", "--width", "reduced", "--out", str(out)])
    assert not out.exists()


def test_width_is_full_or_reduced():
    full = port._live_spec(width="full").cfg
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.dtype) == (
        32, 960, 15, 5, 2560, 49152, "bfloat16")
    small = port._live_spec(width="reduced").cfg
    assert (small.n_layers, small.d_model, small.vocab) == (2, 64, 128)
    with pytest.raises(ValueError):
        port._live_spec(width="half")


def test_captures_warm_up_on_one_stream_a_device(monkeypatch):
    """The churn-live path's memory check found each capture warming up on
    a fresh pool stream, where cuBLAS left a 32 MiB workspace behind: the
    warm-up stream is now one for each device, reused. Two decode captures
    and a train step's warm-ups, run here on the CPU with the CUDA stream,
    graph, synchronise and sync-mode calls faked, make one stream."""
    from repro_torch import compat
    from repro_torch.serving.exec_cache import DecodeExecutable
    from repro_torch.train import train_step

    made = []

    class Stream:
        def __init__(self, device=None, **kw):
            made.append(device)

        def wait_stream(self, other):
            pass

    current = SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(compat, "_WARM_STREAMS", {})
    for name, fake in (("Stream", Stream), ("CUDAGraph", object),
                       ("current_stream", lambda device=None: current),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("graph", lambda g, **kw: contextlib.nullcontext()),
                       ("get_sync_debug_mode", lambda: 0),
                       ("set_sync_debug_mode", lambda mode: None),
                       ("synchronize", lambda device=None: None)):
        monkeypatch.setattr(torch.cuda, name, fake)
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    steps = []
    for _ in range(2):
        exe = SimpleNamespace(device=a, who="m", warm_steps=0,
                              _step=lambda: steps.append("decode"))
        DecodeExecutable._capture(exe, 2)
        assert exe.graph is not None and exe.warm_steps == 2
    tr = SimpleNamespace(device=a, who="t", warm_steps=0,
                         _step=lambda: steps.append("train"),
                         _capture=lambda: steps.append("capture"))
    for _ in range(train_step.WARM_STEPS):
        train_step.TrainExecutable._warm(tr)
    assert steps == ["decode"] * 6 + ["train"] * train_step.WARM_STEPS \
        + ["capture"]
    assert made == [a]
    assert compat.warm_stream(a) is compat.warm_stream(a)
    assert compat.warm_stream(b) is not compat.warm_stream(a)
    assert made == [a, b]
