"""One run of one cell: set-up, the measured window, the drain, and the
records the metric readers take their numbers from.

The window drives the program's own front door, ``Cluster.invoke``, on
the port's DES orchestrator with a ``LiveBackend`` that serves every
invocation on a real replica. Set-up builds the cluster and sends the
first round, which makes the orchestrator create the sandbox (its weights
drawn on the device, its decode step warmed and captured) and admit the
round into its batcher. The window opens as the first pump starts, runs
for its seconds on the host's clock, and then every invocation sent by
its end is drained.

The DES runs as fast as its events allow, never paced by the host's
clock: the live backend bills its pumps' wall time to the DES clock
itself, and nothing of the mix waits on real time. A round's requests are
admitted at one DES instant, so which requests share the batcher's steps
is set by the mix and the DES's own draws, not by the host's timing.
"""
from __future__ import annotations

import gc
import importlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from harness import traffic as T
from harness.backend import BenchBackend, HOOK_SPANS, Spans, StepLog
from harness.des import SWEEP_SCALING, make_dirigent, preload_functions
from harness.trace import TRACE_SECONDS, Trace

FUNCTION = "fn"
CHUNK = 0.01              # DES seconds one env.run covers at most
DRAIN_WALL_S = 120.0      # the drain after the window: wall seconds at most
SETUP_WALL_S = 900.0      # set-up that has not opened the window by then fails
K1_KERNEL = "decode_attention_kernel"
PROGRAM = "repro_torch."   # the package a program config may come from
DES_SEED = 0


@dataclass
class Record:
    """What one run leaves for the metric readers and the check."""

    spec: dict                # the configuration file
    mix: dict                 # the traffic file
    family: str
    setup_s: float = 0.0
    w0: float = 0.0           # the window on the host's clock
    w_end: float = 0.0
    w_stop: float = 0.0       # when the window's last DES call returned
    des_wall_s: float = 0.0
    des0: float = 0.0
    des_s: float = 0.0        # DES seconds the window covered
    spans: Dict[str, float] = field(default_factory=dict)
    steps: list = field(default_factory=list)
    sent: list = field(default_factory=list)     # sent by the window's end
    done_count: Dict[int, int] = field(default_factory=dict)
    completed_in_window: int = 0
    creations_in_window: int = 0
    trace: Optional[dict] = None
    k1_lens: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    sandbox_of: Dict[int, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.w_end - self.w0

    def steps_in_window(self) -> list:
        return [r for r in self.steps if r[0] <= self.w_end]

    @property
    def attempted(self) -> int:
        return len(self.sent)

    def missing(self, inv) -> bool:
        """Failed, or not done by the end of the drain."""
        return inv.failed or inv.t_done < 0


class Driver:
    """Sends the mix's rounds through ``Cluster.invoke`` from one DES
    process, each round when the last is done, and sees every invocation
    done through the cluster's collector, stamped on the host's clock. No
    round is sent once the host's clock has passed ``stop_at``."""

    def __init__(self, env, cl, mix, seed, vocab):
        from repro_torch.core.request import LiveRequest

        self.env, self.cl, self.mix = env, cl, mix
        self.requests = T.Requests(mix, seed, vocab)
        self.LiveRequest = LiveRequest
        self.stop_at = math.inf
        self.window = False       # the window's loop is running
        self.sent: list = []      # every invocation, in order
        self.waiters = {}
        self.done_count: Dict[int, int] = {}
        self.done_in_window = 0
        self.completed = 0
        done = cl.collector.done

        def on_done(inv):
            done(inv)
            inv.t_wall_done = time.perf_counter()
            self.done_count[inv.inv_id] = self.done_count.get(inv.inv_id,
                                                              0) + 1
            self.completed += 1
            if self.window and not inv.failed:
                self.done_in_window += 1
            w = self.waiters.pop(inv.inv_id, None)
            if w is not None:
                w.succeed(inv)

        cl.collector.done = on_done

    def invoke(self, prompt, n):
        inv = self.cl.invoke(FUNCTION, exec_time=0.0,
                             request=self.LiveRequest(prompt=prompt,
                                                      max_new_tokens=n))
        inv.max_new = n
        inv.t_wall = time.perf_counter()
        inv.t_wall_done = -1.0
        self.sent.append(inv)
        return inv

    def client(self, env):
        while time.perf_counter() < self.stop_at:
            waits = []
            for prompt, n in self.requests.round():
                inv = self.invoke(prompt, n)
                if inv.inv_id not in self.done_count:
                    waits.append(self.waiters.setdefault(inv.inv_id,
                                                         env.event()))
            for ev in waits:
                yield ev

    def start(self):
        self.env.process(self.client(self.env), name="client")


def build_program_cfg(ref, spec):
    """The program's config of a configuration file: the fields
    ``ref.arch_kwargs(spec)`` gives, passed to ``ArchConfig``, or, where
    they hold ``program_config`` (``"repro_torch.<module>:<name>"``), to
    the program's callable it names, for a model ``ArchConfig`` cannot
    describe."""
    kw = dict(ref.arch_kwargs(spec))
    target = kw.pop("program_config", None)
    if target is None:
        from repro_torch.configs.base import ArchConfig

        return ArchConfig(**kw)
    module, _, name = target.partition(":")
    if not module.startswith(PROGRAM) or not name:
        raise ValueError(f"program_config {target!r} does not name a "
                         f"callable of the program ({PROGRAM}<module>:<name>)")
    return getattr(importlib.import_module(module), name)(**kw)


def run_cell(spec: dict, mix: dict, ref, seed: int, seconds: float,
             trace: bool, t_process: float,
             device=None) -> "tuple[Record, object]":
    """Run one cell; returns its record and the live backend (closed, its
    replicas freed)."""
    from repro_torch.live import LiveFunctionSpec
    from repro_torch.simcore import Environment

    rec = Record(spec=spec, mix=mix, family=ref.FAMILY)
    cfg = build_program_cfg(ref, spec)
    spans, steps = Spans(), StepLog()
    fspec = LiveFunctionSpec(cfg=cfg, mode="process", max_seq=mix["max_seq"],
                             max_slots=mix["slots"],
                             default_max_new=mix["output_len"]["max"])
    lb = BenchBackend(fspec, spans, steps, device=device)
    on_cuda = lb.device.type == "cuda"
    # the DES's own draws (hop jitter, boot times) model the cluster, not
    # the traffic: the same for every seed
    env = Environment(seed=DES_SEED)
    cl = make_dirigent(env, n_workers=mix["workers"], runtime="firecracker",
                       live_backend=lb, sandbox_concurrency=mix["slots"])
    scaling = dict(SWEEP_SCALING, **mix["scaling"])
    preload_functions(cl, [FUNCTION], scaling)
    drv = Driver(env, cl, mix, seed, spec["vocab_size"])
    tracer = Trace(spans) if trace and on_cuda else None

    # -- set-up: the first round sent; the sandbox created (weights drawn,
    # step captured); a traced run's profiler started (its start takes
    # seconds); the round admitted. The window [w0, w_end] opens on the
    # host's clock as the first pump starts. The loop checks the clock
    # between DES calls, and a pump runs many steps inside one event, so
    # the loop may end after w_end (at w_stop); what is counted "in the
    # window" is clipped to w_end by its own clock reading. A traced run
    # traces the window's first TRACE_SECONDS.
    def created():
        if tracer is not None and tracer.prof is None:
            tracer.start()
            steps.lens_on = True

    def open_window():
        if on_cuda:
            torch.cuda.synchronize(lb.device)
        rec.w0 = time.perf_counter()
        rec.setup_s = rec.w0 - t_process
        rec.w_end = drv.stop_at = rec.w0 + seconds
        drv.window = spans.on = steps.on = True
        if tracer is not None:
            tracer.t0 = rec.w0
        rec.des0 = env.now

    def before_step():
        """Before each logged step: the traced slice's end."""
        if tracer is not None and tracer.running and \
                time.perf_counter() >= rec.w0 + min(TRACE_SECONDS, seconds):
            steps.lens_on = False
            tracer.stop()

    lb.after_create, lb.before_first_collect = created, open_window
    steps.before = before_step
    drv.start()
    while not rec.w0 or time.perf_counter() < rec.w_end:
        if not rec.w0 and time.perf_counter() - t_process > SETUP_WALL_S:
            raise RuntimeError("no request was admitted and pumped in "
                               f"{SETUP_WALL_S:.0f} s of set-up")
        t0 = time.perf_counter()
        with spans("des.run"):
            env.run(until=env.now + CHUNK)
        if drv.window:
            rec.des_wall_s += time.perf_counter() - max(t0, rec.w0)
    if tracer is not None and tracer.running:
        tracer.stop()
    rec.w_stop = time.perf_counter()
    rec.des_s = env.now - rec.des0
    drv.window = spans.on = steps.on = steps.lens_on = False
    steps.before = None
    rec.completed_in_window = drv.done_in_window

    # -- the drain: every invocation sent by the window's end done, or
    # counted missing
    rec.sent = [i for i in drv.sent if i.t_wall <= rec.w_end]
    d0 = time.perf_counter()
    while any(i.t_done < 0 for i in rec.sent) \
            and time.perf_counter() - d0 < DRAIN_WALL_S:
        env.run(until=env.now + CHUNK)
    if on_cuda:
        torch.cuda.synchronize(lb.device)
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            lb.device))

    rec.spans = dict(spans.seconds)
    rec.steps = steps.rows
    rec.k1_lens = steps.lens
    rec.done_count = drv.done_count
    rec.creations_in_window = lb.creations_in_window
    rec.sandbox_of = dict(lb.sandbox_of)
    if tracer is not None and tracer.prof is not None:
        rec.trace = tracer.reduce(K1_KERNEL)
        tracer.prof = None
    lb.close()
    del cl, env, drv
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    return rec, lb


def hook_seconds(rec: Record) -> float:
    return sum(rec.spans.get(n, 0.0) for n in HOOK_SPANS)
