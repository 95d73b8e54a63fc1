"""The port's kernel bench (``benchmarks/torch_kernel_bench.py``) on the
CPU: the reference's six rows (``benchmarks/kernel_bench.py``) under the
same names and in the same order, the chunked and blocked forms it times
equal to the naive forms on the bench's own inputs within the reference's
tolerances, and the CUDA leg not entered.
"""
import importlib.util
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "torch_kernel_bench", os.path.join(ROOT, "benchmarks",
                                       "torch_kernel_bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

from repro_torch.kernels.chunked import ssd_chunked, wkv6_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ref import ssd_ref, wkv6_ref  # noqa: E402
from repro_torch.models.layers import attention_reference  # noqa: E402

# tests/test_kernels.py:28 (fp32), and x5 for the recurrences (:98)
TOL = 2e-5
RECURRENCE_TOL = 5 * TOL


class Rows:
    def __init__(self):
        self.rows = []

    def add(self, name, us, derived=""):
        self.rows.append((name, us, derived))


def _reference_row_names():
    """The row names kernel_bench.py reports, in its order (read as text:
    nothing of JAX is imported)."""
    with open(os.path.join(ROOT, "benchmarks", "kernel_bench.py")) as fh:
        return re.findall(r'reporter\.add\("([^"]+)"', fh.read())


@pytest.fixture(scope="module")
def cpu_run():
    rep = Rows()
    out = bench.run(rep, quick=True, device="cpu")
    return rep, out


def test_rows_are_the_references_in_its_order(cpu_run):
    rep, out = cpu_run
    names = [r[0] for r in rep.rows]
    assert names == _reference_row_names()
    assert len(names) == 6
    assert all(us > 0 for _, us, _ in rep.rows)
    assert rep.rows[0][2] == "S=1024" and rep.rows[4][2] == "S=2048"
    assert set(out) == {"wkv6_speedup", "ssd_speedup"}


def test_cuda_leg_is_not_entered_on_the_cpu(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CUDA leg ran on the CPU")

    monkeypatch.setattr(bench, "cuda_kernels", refuse)

    def once(fn, *args, device=None, **kw):
        fn(*args, **kw)        # the rows' timings are the fixture's test
        return 1e-3

    monkeypatch.setattr(bench, "_time", once)
    rep = Rows()
    out = bench.run(rep, quick=False, device="cpu")
    assert "kernels" not in out and len(rep.rows) == 6


def _close(got, want, tol):
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_wkv6_chunked_equals_the_naive_scan_on_the_bench_inputs():
    args = bench.wkv6_inputs("cpu")
    assert args[0].shape == (2, 1024, 4, 32)
    y_ref, s_ref = wkv6_ref(*args)
    y, s = wkv6_chunked(*args, chunk=64)
    _close(y, y_ref, RECURRENCE_TOL)
    _close(s, s_ref, RECURRENCE_TOL)


def test_ssd_chunked_equals_the_naive_scan_on_the_bench_inputs():
    args = bench.ssd_inputs("cpu")
    assert args[0].shape == (2, 1024, 4, 32) and args[3].shape[-1] == 32
    y_ref, s_ref = ssd_ref(*args)
    y, s = ssd_chunked(*args, chunk=64)
    _close(y, y_ref, RECURRENCE_TOL)
    _close(s, s_ref, RECURRENCE_TOL)


def test_blocked_attention_equals_the_reference_on_the_bench_inputs():
    q, k, v = bench.attention_inputs("cpu")
    assert q.shape == (1, 2048, 4, 64)
    want = attention_reference(q, k, v, causal=True)
    got = flash_attention_plain(q, k, v, causal=True, q_chunk=256,
                                kv_chunk=256)
    _close(got, want, TOL)


def test_cuda_leg_times_chip_smokes_main_shapes(monkeypatch):
    """chip_smoke.py's kernels phase checks and times each kernel's main
    case as the bench defines it (its shape and, through the shared
    helpers, its inputs and bound), and every kernel of the port has a
    row. The phase runs here with its case functions recording their
    arguments."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shared = sys.modules["benchmarks.torch_kernel_bench"]
    assert shared.MAIN == bench.MAIN
    calls = {}

    def spy(name, *args, **kw):
        calls[name] = (args, kw)
        return {"case": name}

    for fn in ("check_decode", "check_decode_graph", "check_flash",
               "check_wkv6", "check_ssd", "check_recurrence_graph",
               "check_decode_lse", "check_grouped", "check_wkv6_decode",
               "check_wkv6_decode_graph", "check_add_rms_norm",
               "check_rope_kv_write", "check_silu_mul"):
        monkeypatch.setattr(smoke, fn, spy)
    monkeypatch.setattr(smoke, "time_designs", lambda *a, **kw: {})
    monkeypatch.setattr(smoke, "emit", lambda *a, **kw: None)
    main = smoke.phase_kernels()
    assert list(main) == [r[0] for r in bench.CUDA_ROWS] == list(smoke.SOURCES)
    for name, case in main.items():
        args, kw = calls[case["case"]]
        assert args == () and kw["timed"]
        assert {k: kw[k] for k in bench.MAIN[name]} == bench.MAIN[name]
    assert smoke.SEED == bench.SEED and smoke.FLASH_CALLS == bench.FLASH_CALLS
    assert smoke.bound is shared.bound and smoke.device_ms is shared.device_ms


def test_no_device_means_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(Rows(), quick=True)
