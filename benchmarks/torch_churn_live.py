"""Live churn bench of the PyTorch/CUDA port: the live half of
``benchmarks/churn_scale.py`` (``--live-grid`` / ``--live-smoke``) on the
port's own orchestrator and live backend.

Every invocation carries a real ``LiveRequest`` that the dispatched
sandbox's replica decodes (Cluster -> DataPlane -> WorkerDaemon ->
``LiveBackend`` -> ``ContinuousBatcher``). The sections are the
reference's, with its traffic letter for letter: cold vs warm sandbox
creation in both modes, a workers x rate grid (8 functions, 4-token
prompts, 8 new tokens, seed 11) and an Azure-like trace slice (10
functions, 150 invocations, seed 42), folded into a calibrated
``DirigentCosts`` candidate. The model is smollm-360m at its published
widths (``--width full``, the default) or the reference's 2-layer stand-in
(``--width reduced``, what the CPU tests run).

    python3 benchmarks/torch_churn_live.py                # the card, full width
    python3 benchmarks/torch_churn_live.py --smoke --width reduced --device cpu

Beside the reference's keys each cell records the device (name, power
limit), the width, the repr of every creation that raised (the simulation
swallows them), the replicas held by no live sandbox, and for each
in-process creation, from ``LiveBackend.start_log``, the seconds of its
replica's build (``build_s``: the skeleton, its weights drawn), its decode
step's eager warm-up (``warm_s``) and its capture (``capture_s``; None on
the CPU, where nothing is captured). The first and the last done
invocations of a trafficked cell are decoded again by a solo replica with
their sandbox's seed. Timings are recorded and never asserted; a cell with a failed
creation, an invocation not done, a done invocation without ``max_new``
tokens in the vocabulary or with other tokens than the solo replica's, a
leaked replica or (on CUDA) a replica that does not decode through its
captured graph makes the run exit non-zero. It writes its own
file (``--out``), never ``BENCH_churn.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):       # `python benchmarks/torch_churn_live.py`
    sys.path.insert(0, ROOT)                         # the benchmarks package
    sys.path.insert(0, os.path.join(ROOT, "src"))    # repro_torch itself

import torch  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    SWEEP_SCALING, latency_stats, make_dirigent, preload_functions,
    run_open_loop,
)
from repro_torch.compat import resolve_device, sync  # noqa: E402
from repro_torch.live import LiveBackend, LiveFunctionSpec  # noqa: E402
from repro_torch.serving.exec_cache import ExecutableCache  # noqa: E402
from repro_torch.simcore import Environment  # noqa: E402

WIDTHS = ("full", "reduced")
GRID = ((8, 50.0, 2.0), (16, 100.0, 2.0), (32, 200.0, 2.0))
MAX_NEW = 8


def gpu_line():
    """``name, power.limit`` as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_info(device) -> dict:
    """What a cell's timings were taken on: the device, and on CUDA the
    card's name and power limit."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {"device": str(device), "name": platform.processor() or None,
                "power_limit": None}
    line = gpu_line()
    return {"device": str(device),
            "name": torch.cuda.get_device_name(device),
            "power_limit": line.rsplit(",", 1)[-1].strip() if line else None}


def bench_provenance(device=None) -> dict:
    """Run provenance for the file: enough to judge whether two recorded
    wall-clock numbers are comparable (same tree? same card, same power
    limit, same toolchain?)."""
    prov = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "python": platform.python_version(),
        "numpy": np.__version__,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    try:
        prov["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=ROOT).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        prov["git_sha"] = None
    try:
        from repro_torch.kernels import build
        out = subprocess.run([build.find_nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60)
        prov["nvcc"] = out.stdout.strip().splitlines()[-1]
    except Exception:                 # noqa: BLE001 — nvcc is optional here
        prov["nvcc"] = None
    prov["gpu"] = gpu_line()
    prov["device"] = device_info(device)
    return prov


# -- the live backend, with what the bench records ------------------------------

class BenchBackend(LiveBackend):
    """``LiveBackend`` on a fresh ``ExecutableCache`` that also records why
    a creation failed, whether an in-process replica decodes through its
    captured graph, which sandbox took which request, the decode steps of
    every batcher (torn-down ones included) and the most replicas alive at
    once. The split of a creation is the backend's own ``start_log`` row's
    (``build_s``, ``warm_s``, ``capture_s``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, exec_cache=ExecutableCache(), **kw)
        self.create_errors = []
        self.sandbox_of = {}
        self.retired_steps = 0
        self.peak_replicas = 0

    def create_hook(self, sandbox) -> None:
        try:
            super().create_hook(sandbox)
        except Exception as e:
            self.create_errors.append(repr(e))
            raise
        self.peak_replicas = max(self.peak_replicas, len(self.sandboxes))
        row = self.start_log[-1]
        if row["mode"] != "process":
            return
        rt = self.sandboxes[sandbox.sandbox_id]
        exe = rt.replica.executable(rt.spec.max_slots)
        row["captured"] = exe.graph is not None \
            and rt.batcher.cache is exe.cache

    def admit(self, sandbox_id, req):
        ticket = super().admit(sandbox_id, req)
        self.sandbox_of[id(req)] = sandbox_id
        return ticket

    def teardown_hook(self, sandbox_id: int, drain: bool = True) -> None:
        rt = self.sandboxes.get(sandbox_id)
        super().teardown_hook(sandbox_id, drain)
        if rt is not None and hasattr(rt, "batcher"):
            self.retired_steps += rt.batcher.steps

    def decode_steps(self) -> int:
        return self.retired_steps + sum(
            rt.batcher.steps for rt in self.sandboxes.values()
            if hasattr(rt, "batcher"))


def _median_ms(rows, key):
    vals = [r[key] for r in rows if r.get(key) is not None]
    return round(1e3 * float(np.median(vals)), 2) if vals else None


def _split(rows) -> dict:
    """Median build, warm-up and capture ms of the cold and the warm
    creations (from each ``start_log`` row)."""
    cold = [r for r in rows if r["cold"]]
    warm = [r for r in rows if not r["cold"]]
    return {f"{tag}_{k}_ms_median": _median_ms(group, key)
            for tag, group in (("cold", cold), ("warm", warm))
            for k, key in (("build", "build_s"), ("warmup", "warm_s"),
                           ("capture", "capture_s"))}


def _creates(lb) -> list:
    return [{k: r.get(k) for k in ("sandbox_id", "cold", "wall_s", "build_s",
                                   "warm_s", "capture_s", "captured")}
            for r in lb.start_log]


def _leaked(cl, lb) -> list:
    """Replicas the backend holds for no live sandbox of the cluster."""
    live_ids = {sid for w in cl.workers.values() for sid in w.sandboxes}
    return [sid for sid in lb.sandboxes if sid not in live_ids]


def _bad_tokens(done, vocab: int) -> int:
    """Done invocations whose tokens are not MAX_NEW ids of the vocabulary."""
    return sum(1 for i in done
               if i.request.tokens is None
               or len(i.request.tokens) != MAX_NEW
               or not all(0 <= t < vocab for t in i.request.tokens))


def solo_check(spec, device, done, sandbox_of) -> dict:
    """The first and the last done invocations against a fresh replica
    with their sandbox's seed: the same weights, alone in a batch of one,
    must give the same greedy tokens. Run once the cell's backend is
    closed, on an ``ExecutableCache`` of its own; ``solo_steps`` counts
    its decode steps, the eager warm-up ones included."""
    from repro_torch.serving.engine import Replica

    cache, rows, steps = ExecutableCache(), [], 0
    for inv in done[:1] + done[1:][-1:]:
        sid = sandbox_of[id(inv.request)]
        solo = Replica(spec.cfg, rng_seed=sid, max_seq=spec.max_seq,
                       run_cfg=spec.run_cfg, exec_cache=cache, device=device)
        toks = solo.generate(list(inv.request.prompt), max_new_tokens=MAX_NEW)
        steps += solo.stats["decode_steps"]
        rows.append({"sandbox_id": sid, "inv_id": inv.inv_id,
                     "equal": toks == list(inv.request.tokens)})
        del solo
    return {"solo_checks": rows, "solo_steps": steps + cache.warm_steps}


def failures(cell: dict) -> list:
    """What makes a cell fail the run: failed creations, invocations not
    done, done ones without their tokens or with other tokens than a solo
    replica's, leaked replicas, and on CUDA a replica that does not decode
    through its captured graph."""
    out = []
    if cell.get("create_errors"):
        out.append(f"create errors: {cell['create_errors']}")
    if "total" in cell and cell["done"] < cell["total"]:
        out.append(f"done {cell['done']} < total {cell['total']}")
    if cell.get("bad_tokens"):
        out.append(f"{cell['bad_tokens']} done invocations without "
                   f"{MAX_NEW} tokens in the vocabulary")
    differ = [r for r in cell.get("solo_checks", ()) if not r["equal"]]
    if differ:
        out.append(f"tokens differ from a solo replica's: {differ}")
    if cell.get("leaked_replicas"):
        out.append(f"{cell['leaked_replicas']} leaked replicas")
    if cell["device"]["device"].startswith("cuda") and not all(
            r["captured"] for r in cell.get("creates", [])
            if r["captured"] is not None):
        out.append("a replica does not decode through its captured graph")
    return out


# -- live execution mode (real payloads on the port) ----------------------------

def _live_spec(mode: str = "process", max_slots: int = 4,
               max_seq: int = 64, max_new: int = MAX_NEW,
               width: str = "full"):
    """The smollm config every live cell shares: at its published widths
    (``full``), or the reference's truncated stand-in (``reduced``)."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-360m")
    if width == "reduced":
        cfg = cfg.reduced(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                          vocab=128)
    elif width != "full":
        raise ValueError(f"width {width!r} is not one of {WIDTHS}")
    return LiveFunctionSpec(cfg=cfg, mode=mode, max_seq=max_seq,
                            max_slots=max_slots, default_max_new=max_new)


def live_cold_warm_point(mode: str = "process", n_warm: int = 4,
                         width: str = "full", device=None) -> dict:
    """Cold vs warm live sandbox creation.

    Process mode: a fresh ``ExecutableCache``; the first creation warms
    and captures a new decode signature (cold), the rest find it warmed
    and capture their own replica's step (warm). Container mode: a fresh
    kernel build directory under ``build/``; the first spawned worker
    builds the kernel library there (on CUDA), the next loads it instead
    (n_warm is clamped to 1 — workers cost seconds each)."""
    from repro_torch.core.abstractions import Sandbox

    cache_dir = None
    if mode == "container":
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        cache_dir = tempfile.mkdtemp(prefix="container-bench-",
                                     dir=os.path.join(ROOT, "build"))
        n_warm = 1
    spec = _live_spec(mode, width=width)
    lb = BenchBackend(default_spec=spec, compile_cache_dir=cache_dir,
                      device=device)
    try:
        for i in range(1 + n_warm):
            sb = Sandbox(sandbox_id=i + 1, function_name="lf",
                         ip=(10, 0, 0, 1), port=80, worker_id=0)
            lb.create_hook(sb)
        rows = lb.start_log
        assert rows[0]["cold"] and not any(r["cold"] for r in rows[1:]), \
            "cold/warm split did not land where expected"
        cold = rows[0]["wall_s"]
        warm = float(np.median([r["wall_s"] for r in rows[1:]]))
        out = {"mode": mode, "cold_create_s": round(cold, 4),
               "warm_create_s": round(warm, 4),
               "warm_speedup": round(cold / max(warm, 1e-9), 1),
               "n_warm": n_warm,
               "exec_cache": lb.cache_stats()}
        out.update(device=device_info(lb.device), width=width,
                   create_errors=lb.create_errors, **_split(rows),
                   warm_steps=lb.exec_cache.warm_steps,
                   decode_steps=lb.decode_steps(), creates=_creates(lb))
    finally:
        lb.close()
        if cache_dir:
            shutil.rmtree(cache_dir, ignore_errors=True)
    out["leaked_replicas"] = lb.replicas_live
    return out


def live_grid_point(n_workers: int, rate: float, duration: float,
                    mode: str = "process", n_functions: int = 8,
                    seed: int = 11, max_slots: int = 4, width: str = "full",
                    device=None) -> dict:
    """One live workers x rate cell: every invocation carries a real
    ``LiveRequest`` executed in the dispatched sandbox's batcher."""
    from repro_torch.core.request import LiveRequest

    env = Environment(seed=seed)
    spec = _live_spec(mode, max_slots=max_slots, width=width)
    lb = BenchBackend(default_spec=spec, device=device)
    if lb.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(lb.device)
    cl = make_dirigent(env, n_workers=n_workers, runtime="firecracker",
                       live_backend=lb, sandbox_concurrency=max_slots)
    plan = [(i / rate, f"lf{i % n_functions}", 0.02)
            for i in range(int(rate * duration))]
    preload_functions(cl, [p[1] for p in plan], SWEEP_SCALING)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, 127, size=(len(plan), 4))

    def req_factory(i):
        return LiveRequest(prompt=[int(t) for t in prompts[i]],
                           max_new_tokens=MAX_NEW)

    ev0, t0 = env.events_processed, time.perf_counter()
    invs = run_open_loop(env, cl, plan, until_extra=10.0,
                         request_factory=req_factory)
    wall = time.perf_counter() - t0
    try:
        done = [i for i in invs if i.t_done > 0 and not i.failed]
        executed = [i for i in done if i.request.tokens is not None]
        assert len(executed) == len(done), \
            "completed invocation without real payload execution"
        stats = latency_stats(invs, "e2e_latency")
        inv_walls = sorted(i.request.wall_s for i in executed) or [0.0]
        creations = cl.collector.sandbox_creations
        cold = [r for r in lb.start_log if r["cold"]]
        warm = [r for r in lb.start_log if not r["cold"]]
        out = {
            "workers": n_workers, "rate": rate, "duration": duration,
            "mode": mode, "n_functions": n_functions,
            "max_slots": max_slots,
            "wall_s": round(wall, 3), "sim_s": round(env.now, 3),
            "events": env.events_processed - ev0,
            "creations": creations,
            "creations_per_wall_s": round(creations / wall, 1),
            "cold_creates": len(cold), "warm_creates": len(warm),
            "cold_create_ms_median": round(
                1e3 * float(np.median([r["wall_s"] for r in cold])), 2)
            if cold else None,
            "warm_create_ms_median": round(
                1e3 * float(np.median([r["wall_s"] for r in warm])), 2)
            if warm else None,
            "done": stats["done"], "total": stats["total"],
            "p50_ms": round(stats["p50"] * 1e3, 3),
            "p99_ms": round(stats["p99"] * 1e3, 3),
            "invoke_wall_p50_ms": round(
                1e3 * inv_walls[len(inv_walls) // 2], 3),
            "invoke_wall_p99_ms": round(
                1e3 * inv_walls[int(len(inv_walls) * 0.99) - 1], 3),
            "tokens": lb.tokens_total,
            "tokens_per_wall_s": round(lb.tokens_total / wall, 1),
            "batched_invokes": lb.batched_invokes,
            "exec_cache": lb.cache_stats(),
            "_start_log": lb.start_log,
            "_invoke_walls": inv_walls,
        }
        out.update(device=device_info(lb.device), width=width,
                   create_errors=lb.create_errors,
                   leaked_replicas=len(_leaked(cl, lb)),
                   bad_tokens=_bad_tokens(done, spec.cfg.vocab),
                   executed=len(executed), peak_replicas=lb.peak_replicas,
                   **_split(lb.start_log), warm_steps=lb.exec_cache.warm_steps,
                   creates=_creates(lb))
    finally:
        lb.close()
    out["decode_steps"] = lb.decode_steps()
    out["leaked_replicas"] += lb.replicas_live
    if lb.device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(lb.device)
    out.update(solo_check(spec, lb.device, done, lb.sandbox_of))
    return out


def live_azure_slice(n_functions: int = 10, duration: float = 6.0,
                     target_invocations: int = 150, n_workers: int = 16,
                     seed: int = 42, width: str = "full",
                     device=None) -> dict:
    """Azure-trace slice replayed end-to-end in live mode: the Shahrad-style
    workload shape (Zipf popularity, lognormal exec times, timer + Poisson
    arrivals) with a real ``LiveRequest`` on every invocation."""
    from benchmarks.azure_trace import generate_azure_like_trace
    from repro_torch.core.request import LiveRequest

    trace = generate_azure_like_trace(
        n_functions=n_functions, duration=duration,
        target_invocations=target_invocations, seed=seed,
        timer_fraction=0.2, n_timer_groups=2)
    env = Environment(seed=seed)
    spec = _live_spec("process", width=width)
    lb = BenchBackend(default_spec=spec, device=device)
    if lb.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(lb.device)
    cl = make_dirigent(env, n_workers=n_workers, runtime="firecracker",
                       live_backend=lb, sandbox_concurrency=4)
    preload_functions(cl, [f.name for f in trace.functions], SWEEP_SCALING)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, 127, size=(len(trace.invocations), 4))

    def req_factory(i):
        return LiveRequest(prompt=[int(t) for t in prompts[i]],
                           max_new_tokens=MAX_NEW)

    t0 = time.perf_counter()
    invs = run_open_loop(env, cl, trace.invocations, until_extra=15.0,
                         request_factory=req_factory)
    wall = time.perf_counter() - t0
    try:
        done = [i for i in invs if i.t_done > 0 and not i.failed]
        executed = [i for i in done if i.request.tokens is not None]
        assert len(executed) == len(done), \
            "azure slice: completed invocation without payload execution"
        stats = latency_stats(invs, "e2e_latency")
        inv_walls = sorted(i.request.wall_s for i in executed) or [0.0]
        out = {
            "n_functions": n_functions, "trace_duration": duration,
            "invocations": len(trace.invocations),
            "workers": n_workers,
            "wall_s": round(wall, 3), "sim_s": round(env.now, 3),
            "creations": cl.collector.sandbox_creations,
            "done": stats["done"], "total": stats["total"],
            "real_payloads_executed": len(executed),
            "p50_ms": round(stats["p50"] * 1e3, 3),
            "p99_ms": round(stats["p99"] * 1e3, 3),
            "tokens": lb.tokens_total,
            "batched_invokes": lb.batched_invokes,
            "exec_cache": lb.cache_stats(),
        }
        out.update(device=device_info(lb.device), width=width,
                   create_errors=lb.create_errors,
                   leaked_replicas=len(_leaked(cl, lb)),
                   bad_tokens=_bad_tokens(done, spec.cfg.vocab),
                   peak_replicas=lb.peak_replicas,
                   invoke_wall_p50_ms=round(
                       1e3 * inv_walls[len(inv_walls) // 2], 3),
                   invoke_wall_p99_ms=round(
                       1e3 * inv_walls[int(len(inv_walls) * 0.99) - 1], 3),
                   tokens_per_wall_s=round(lb.tokens_total / wall, 1),
                   **_split(lb.start_log), creates=_creates(lb))
    finally:
        lb.close()
    out["leaked_replicas"] += lb.replicas_live
    if lb.device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(lb.device)
    out.update(solo_check(spec, lb.device, done, lb.sandbox_of))
    return out


def live_grid_section(smoke: bool = False, width: str = "full",
                      device=None) -> dict:
    """The live execution sweep — cold/warm creation for both modes, a
    workers x rate grid with real payloads on every invoke, and an
    Azure-trace slice. Per-phase wall measurements are folded into a
    calibrated ``DirigentCosts`` candidate (``costs_candidate``) for DES
    cross-checking. On CUDA the context is made and the kernel library
    loaded (built if this tree's is not) before the first cell, their
    seconds recorded: a cold creation is a new decode signature's skeleton,
    warm-up and capture, with the first use of each of its kernels."""
    from repro_torch.core.costmodel import live_calibrated_candidate

    section: dict = {"provenance": bench_provenance(device), "width": width}
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        torch.empty(1, device=dev)
        sync(dev)
        section["cuda_init_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        section["kernel_library_was_built"] = build.is_built()
        build.load()
        section["kernel_library_s"] = round(time.perf_counter() - t0, 3)
    section["cold_warm"] = [live_cold_warm_point("process", width=width,
                                                 device=device)]
    if not smoke:
        section["cold_warm"].append(live_cold_warm_point(
            "container", width=width, device=device))
    for row in section["cold_warm"]:
        print(f"live cold/warm mode={row['mode']}: "
              f"cold={row['cold_create_s'] * 1e3:.0f}ms "
              f"warm={row['warm_create_s'] * 1e3:.1f}ms "
              f"-> {row['warm_speedup']:.0f}x "
              f"(build/warm-up/capture ms: cold "
              f"{row['cold_build_ms_median']}/"
              f"{row['cold_warmup_ms_median']}/"
              f"{row['cold_capture_ms_median']}, warm "
              f"{row['warm_build_ms_median']}/"
              f"{row['warm_warmup_ms_median']}/"
              f"{row['warm_capture_ms_median']})", flush=True)

    grid = GRID[:1] if smoke else GRID
    cells, start_log, invoke_walls = [], [], []
    for w, r, d in grid:
        cell = live_grid_point(w, r, d, width=width, device=device)
        start_log += cell.pop("_start_log")
        invoke_walls += cell.pop("_invoke_walls")
        cells.append(cell)
        print(f"live workers={w} rate={r:.0f}: "
              f"{cell['creations_per_wall_s']:.0f} creations/s wall "
              f"(cold {cell['cold_create_ms_median']}ms / warm "
              f"{cell['warm_create_ms_median']}ms), "
              f"invoke p50={cell['invoke_wall_p50_ms']}ms "
              f"p99={cell['invoke_wall_p99_ms']}ms, "
              f"{cell['tokens_per_wall_s']:.0f} tok/s, "
              f"batched={cell['batched_invokes']}, "
              f"done={cell['done']}/{cell['total']}", flush=True)
    section["grid"] = cells
    section["azure_slice"] = live_azure_slice(width=width, device=device)
    az = section["azure_slice"]
    print(f"live azure slice: {az['real_payloads_executed']}/{az['total']} "
          f"real invokes, {az['creations']} creations, "
          f"p99={az['p99_ms']:.1f}ms, {az['tokens']} tokens", flush=True)
    # container cold/warm rows feed the candidate too
    for row in section["cold_warm"]:
        start_log.append({"mode": row["mode"], "cold": True,
                          "wall_s": row["cold_create_s"]})
        start_log.append({"mode": row["mode"], "cold": False,
                          "wall_s": row["warm_create_s"]})
    section["costs_candidate"] = live_calibrated_candidate(
        start_log, invoke_walls)
    return section


def run_live_grid(out: str = "BENCH_churn_live_torch.json",
                  smoke: bool = False, width: str = "full",
                  device=None) -> dict:
    """Run the live execution sweep (with ``smoke``, its seconds-scale
    subset and the reference's real-invoke smoke cell) and write it, with
    every cell's failures, to ``out``."""
    resolve_device(device)            # no device, no file
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a"):              # fail on an unwritable path up front
        pass
    result = {"meta": {"bench": "torch_churn_live", "smoke": smoke,
                       "width": width}}
    section = live_grid_section(smoke=smoke, width=width, device=device)
    result["live_grid"] = section
    cells = (section["cold_warm"] + section["grid"]
             + [section["azure_slice"]])
    if smoke:
        real = live_grid_point(4, 20.0, 1.0, n_functions=2, width=width,
                               device=device)
        real.pop("_start_log")
        real.pop("_invoke_walls")
        print(f"live real-invoke: done={real['done']}/{real['total']} "
              f"tokens={real['tokens']} "
              f"(cold {real['cold_create_ms_median']}ms / warm "
              f"{real['warm_create_ms_median']}ms)", flush=True)
        result["live_smoke"] = {"real_invoke": real}
        cells.append(real)
    result["failures"] = [f for c in cells for f in failures(c)]
    with open(out, "w") as fh:
        json.dump(result, fh, indent=2)
    print(f"wrote {out}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale subset: process cold/warm, one grid "
                         "cell, the Azure slice, the real-invoke cell")
    ap.add_argument("--width", choices=WIDTHS, default="full",
                    help="smollm-360m at its published widths (full) or the "
                         "reference's 2-layer stand-in (reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; the CPU only when "
                         "asked)")
    ap.add_argument("--out", default="BENCH_churn_live_torch.json")
    args = ap.parse_args(argv)
    result = run_live_grid(out=args.out, smoke=args.smoke, width=args.width,
                           device=args.device)
    for f in result["failures"]:
        print(f"torch_churn_live: FAILED: {f}", file=sys.stderr)
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
