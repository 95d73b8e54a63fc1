"""The metrics read from the program's own spans (``harness/program_spans.py``):
their arithmetic on hand-made spans that straddle the set-up, the names the
program records against the prefixes the trace's reduction keys on, a
whole tiny run on the CPU, and on the card a traced run of each cell that
reports both and names the program's spans among the idle gaps."""
import sys
import time

import pytest
import torch

from harness import program_spans as P
from harness.cell import Record
from harness.manifest import Manifest
from harness.measure import measure
from harness.trace import SPAN_PREFIXES
from test_faasbench_faults import SEED, SMALL
from test_faasbench_manifest import ROOT
from test_faasbench_reference import tiny_patch

MAN = Manifest(ROOT)
CELLS = [w["name"] for w in MAN.bench["workloads"]]
METRICS = ("create_warm_s", "create_capture_s")


class _Span:
    def __init__(self, name, start, end, parent=None, **attrs):
        self.name, self.start, self.end = name, start, end
        self.parent, self.attrs = parent, attrs

    @property
    def seconds(self):
        return self.end - self.start


def _rec():
    """A window [10, 20] after a set-up of 4 s."""
    r = Record(spec={}, mix={}, family="dense")
    r.w0, r.w_end, r.setup_s = 10.0, 20.0, 4.0
    return r


def _log(monkeypatch, spans):
    monkeypatch.setattr(P, "program_spans", lambda: spans)


@pytest.mark.parametrize("metric,name", [(P.create_warm_s, "backend.warm"),
                                         (P.create_capture_s,
                                          "backend.capture")])
def test_creation_seconds_read_the_setup(monkeypatch, metric, name):
    _log(monkeypatch, [
        _Span(name, 1.0, 5.5),              # ends before the set-up began
        _Span(name, 5.5, 6.25),             # begins just before, ends in it
        _Span(name, 7.0, 7.5),
        _Span(name, 9.5, 10.5),             # ends in the window
        _Span("backend.create", 5.0, 9.0)])
    assert metric(_rec()) == pytest.approx(1.25)
    _log(monkeypatch, [_Span("backend.create", 7.0, 8.0)])
    assert metric(_rec()) is None


def test_creation_seconds_leave_the_kernel_library_out(monkeypatch):
    """The kernel library's first build and load (``backend.kernels.load``)
    inside a warm-up is not the warm-up's; one outside any span, or under
    another, takes nothing away."""
    first = _Span("backend.warm", 6.0, 9.0)
    later = _Span("backend.warm", 9.2, 9.7)
    create = _Span("backend.create", 5.0, 9.8)
    _log(monkeypatch, [
        _Span(P.KERNELS, 6.1, 8.6, first), first, later,
        _Span(P.KERNELS, 5.0, 5.5), _Span(P.KERNELS, 9.75, 9.78, create),
        create])
    assert P.create_warm_s(_rec()) == pytest.approx(0.5 + 0.5)


def test_no_tracer_in_the_program_reads_nothing(monkeypatch):
    """A program without ``repro_torch.trace`` gives an empty log, and
    every reader None."""
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    assert P.program_spans() == []
    rec = _rec()
    assert all(getattr(P, m)(rec) is None for m in METRICS)


def _tiny_run(cell, trace):
    torch.set_num_threads(2)
    return measure(MAN, cell, SEED, 1.0, trace, time.perf_counter(),
                   device="cpu", spec_patch=tiny_patch(MAN, cell),
                   mix_patch=SMALL)


def test_recorded_names_have_the_traces_prefixes():
    """Every span the program records in a tiny run under a profiler has a
    prefix ``harness/trace.py`` leaves out of the device's work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = _tiny_run(CELLS[0], False)
    names = {s.name for s in trace.spans()}
    trace.clear()
    assert out["correct"]
    assert {"batcher.step", "batcher.read", "backend.pump",
            "backend.create"} <= names
    assert all(n.startswith(SPAN_PREFIXES) for n in names), names


def test_tiny_traced_run_reports_what_the_cpu_allows():
    """A traced run on the CPU reads the creation's warm-up; nothing is
    captured, so no capture is read."""
    out = _tiny_run("smollm-360m.closed", True)
    got = out["metrics"]
    assert out["correct"]
    assert got["create_warm_s"]["value"] > 0
    assert got["create_warm_s"]["unit"] == "s"
    assert "create_capture_s" not in got


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_spans(card, cell):
    import run

    run.set_env()
    out = measure(MAN, cell, 2 ** 31 + 11, 8.0, True, time.perf_counter())
    got = {k: out["metrics"][k]["value"] for k in METRICS
           if k in out["metrics"]}
    assert set(got) == set(METRICS), out["metrics"]
    assert all(v > 0 for v in got.values()), got
    gaps = {n for n, _ in out["breakdown"]["idle_gaps"]}
    assert gaps & {"batcher.read", "batcher.stage", "batcher.replay",
                   "backend.pump"}, gaps
