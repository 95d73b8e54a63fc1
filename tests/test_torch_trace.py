"""The port's spans (``repro_torch.trace``) on the CPU: a step-path site
records nothing and costs one flag read while no profiler records; under a
``torch.profiler`` session every step-path span is recorded with its parent
and shows among the profiler's events; a creation records its build,
warm-up and capture always, and its ``start_log`` row carries their
seconds; the kernel library's first load is a span of its own; every name
has one of the two prefixes; the log keeps the newest spans."""
import contextlib
import os
import re
from collections import deque
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.abstractions import Sandbox  # noqa: E402
from repro_torch.core.request import LiveRequest  # noqa: E402
from repro_torch.live import LiveBackend, LiveFunctionSpec  # noqa: E402
from repro_torch.serving.exec_cache import (DecodeExecutable,  # noqa: E402
                                            ExecutableCache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = get_config("smollm-360m").reduced(
    n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128)
SLOTS = 4
STEP_SPANS = {"backend.pump", "batcher.step", "batcher.stage",
              "batcher.replay", "batcher.read"}


@pytest.fixture(autouse=True)
def empty_log():
    trace.clear()
    yield
    trace.clear()


def _backend():
    spec = LiveFunctionSpec(cfg=TINY, mode="process", max_seq=64,
                            max_slots=SLOTS, default_max_new=4)
    lb = LiveBackend(default_spec=spec, exec_cache=ExecutableCache(),
                     device="cpu")
    lb.create_hook(Sandbox(sandbox_id=7, function_name="lf", ip=(10, 0, 0, 1),
                           port=80, worker_id=0))
    return lb


def _serve(lb):
    """Two co-resident requests admitted and collected."""
    t1 = lb.admit(7, LiveRequest(prompt=[1, 2], max_new_tokens=3))
    t2 = lb.admit(7, LiveRequest(prompt=[5, 6, 7], max_new_tokens=2))
    for t in (t1, t2):
        assert not lb.collect(t).failed
    return t1, t2


class _FakeGraph:
    """A captured graph's stand-in: a replay writes logits from the staged
    tokens (so the replay path, with its timing events, runs on the CPU)."""

    def __init__(self, exe):
        self.exe = exe

    def replay(self):
        self.exe.logits.copy_(self.exe.tokens.float().expand_as(
            self.exe.logits))


class _Event:
    """``torch.cuda.Event``'s stand-in: every pair is 1.25 ms apart."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1

    def record(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.25


def _replaying(lb):
    """The sandbox's executable made to replay a fake graph."""
    rt = lb.sandboxes[7]
    exe = rt.replica.executable(SLOTS)
    assert exe.cache is rt.batcher.cache and exe.logits is not None
    exe.graph = _FakeGraph(exe)
    return exe


def test_no_profiler_no_span_no_clock_no_event(monkeypatch):
    """With no profiler recording, a batcher's steps and a backend's admit
    and collect, eager and replayed, build no span, read no clock and build
    no CUDA event: each site reads the profiler's flag and nothing else."""
    lb = _backend()
    try:
        _serve(lb)                          # eager: the logits exist after
        exe = _replaying(lb)
        trace.clear()

        def refuse(*a, **kw):
            raise AssertionError("a step-path site did more than read a flag")

        monkeypatch.setattr(trace, "perf_counter", refuse)
        monkeypatch.setattr(trace, "Span", refuse)
        monkeypatch.setattr(torch.cuda, "Event", refuse)
        steps0 = exe.replays
        _serve(lb)
        assert exe.replays > steps0
        assert trace.spans() == []
    finally:
        lb.close()


def _names(spans):
    return {s.name for s in spans}


def test_profiler_records_every_step_span(monkeypatch):
    """Under a CPU profiler, the same calls record each step-path span with
    its parent; a replay's ``device_ms`` comes from its two events, the
    eager step has none."""
    lb = _backend()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    try:
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            _serve(lb)                              # eager
            _replaying(lb)
            made = _Event.made
            _serve(lb)                              # replayed
        assert _Event.made - made >= 2
    finally:
        lb.close()
    got = trace.spans()
    assert _names(got) == STEP_SPANS
    by = {n: [s for s in got if s.name == n] for n in STEP_SPANS}
    pumps = by["backend.pump"]
    assert len(pumps) == 4 and all(p.parent is None for p in pumps)
    # a request done while its neighbour pumped is collected in no step
    steps = [[s for s in by["batcher.step"] if s.parent is p] for p in pumps]
    assert [len(st) > 0 for st in steps] == [True, False] * 2
    assert sum(map(len, steps)) == len(by["batcher.step"])
    for n in ("batcher.stage", "batcher.replay", "batcher.read"):
        assert len(by[n]) == len(by["batcher.step"])
        assert all(s.parent.name == "batcher.step" for s in by[n])
    for s in got:
        assert s.start <= s.end
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    timed = [s.attrs.get("device_ms") for s in by["batcher.replay"]]
    assert None in timed and set(timed) == {None, 1.25}


def test_spans_are_among_the_profilers_events():
    lb = _backend()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _serve(lb)
    finally:
        lb.close()
    assert STEP_SPANS <= {e.name for e in prof.events()}


@pytest.mark.parametrize("profiled", [False, True])
def test_creation_records_build_and_warm_up(profiled):
    """A process-mode creation records its span, its replica's build and
    its decode step's warm-up with or without a profiler (on the CPU nothing
    is captured), and its ``start_log`` row their seconds."""
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiled \
        else contextlib.nullcontext()
    with ctx:
        lb = _backend()
    lb.close()
    got = trace.spans()
    by = {s.name: s for s in got}
    assert _names(got) == {"backend.create", "backend.create.build",
                           "backend.warm"}
    create = by["backend.create"]
    assert create.parent is None
    assert by["backend.create.build"].parent is create
    assert by["backend.warm"].parent is create
    row = lb.start_log[0]
    assert row["wall_s"] == round(create.seconds, 6)
    assert row["build_s"] == round(by["backend.create.build"].seconds, 6)
    assert row["warm_s"] == round(by["backend.warm"].seconds, 6)
    assert row["capture_s"] is None
    assert row["build_s"] + row["warm_s"] <= row["wall_s"] + 1e-5


def test_capture_records_warm_up_and_capture(monkeypatch):
    """On a CUDA device a decode executable's warm-up and capture are two
    spans; here with the CUDA calls faked, as the churn tests' warm-stream
    check fakes them."""
    from repro_torch import compat
    from repro_torch.kernels import ops

    stream = SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(compat, "_WARM_STREAMS", {})
    for name, fake in (("Stream", lambda device=None, **kw: stream),
                       ("CUDAGraph", object),
                       ("current_stream", lambda device=None: stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("graph", lambda g, **kw: contextlib.nullcontext()),
                       ("get_sync_debug_mode", lambda: 0),
                       ("set_sync_debug_mode", lambda mode: None),
                       ("synchronize", lambda device=None: None)):
        monkeypatch.setattr(torch.cuda, name, fake)

    def step():
        ops.add_launches({"decode_attention": 3})

    exe = SimpleNamespace(device=torch.device("cuda", 0), who="m",
                          warm_steps=0, _step=step)
    before = ops.launch_counts()
    DecodeExecutable._capture(exe, 2)
    ops.add_launches(ops.launch_delta(before), times=-1)
    got = trace.spans()
    assert [s.name for s in got] == ["backend.warm", "backend.capture"]
    warm, cap = got
    assert warm.end <= cap.start
    assert exe.replay_counts == {"decode_attention": 3}
    assert exe.warm_s == warm.seconds and exe.capture_s == cap.seconds


def test_every_name_has_a_prefix():
    """Every span the program can record (each literal name at a site)
    and every span a served request and a creation record start with
    ``backend.`` or ``batcher.``."""
    assert trace.PREFIXES == ("backend.", "batcher.")
    site = re.compile(r"trace\.(?:step|Span)\(\s*\"([^\"]+)\"")
    named = set()
    for d, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    named |= set(site.findall(fh.read()))
    assert named >= STEP_SPANS | {"backend.create", "backend.create.build",
                                  "backend.warm", "backend.capture",
                                  "backend.kernels.load"}
    with profile(activities=[ProfilerActivity.CPU]):
        lb = _backend()
        try:
            _serve(lb)
        finally:
            lb.close()
    recorded = _names(trace.spans())
    assert recorded <= named
    assert all(n.startswith(trace.PREFIXES) for n in named | recorded)


def test_kernel_library_load_is_a_span_inside_the_warm_up(monkeypatch):
    """The process's first load of the kernel library (here its build and
    ``dlopen`` faked) is ``backend.kernels.load``, a child of the warm-up
    that triggers it; a later load records nothing."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda verbose_ptxas=False: "lib.so")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_declare", lambda lib: None)
    with trace.Span("backend.warm") as warm:
        lib = build.load()
    assert build.load() is lib
    got = trace.spans()
    assert [s.name for s in got] == ["backend.kernels.load", "backend.warm"]
    assert got[0].parent is warm and got[0].seconds <= warm.seconds


def test_log_keeps_the_newest_spans(monkeypatch):
    assert trace._log.maxlen == trace.CAP
    monkeypatch.setattr(trace, "_log", deque(maxlen=2))
    for i in range(5):
        with trace.Span("backend.x") as s:
            s.attrs["i"] = i
    assert [s.attrs["i"] for s in trace.spans()] == [3, 4]
    trace.clear()
    assert trace.spans() == []
