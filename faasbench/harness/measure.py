"""A cell's run from its name to the result line: the program run, the
metrics read, the comparison made, the import guard."""
from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from harness import check
from harness.cell import run_cell
from harness.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GAPS = ("mean_gap", "worst_request_gap")     # the served tokens' numbers


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not load: JAX, its libraries, the JAX package."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def measure(man: Manifest, name: str, seed: int, seconds: float, trace: bool,
            t_process: float, device=None, spec_patch: Optional[dict] = None,
            mix_patch: Optional[dict] = None,
            limits: Optional[dict] = None) -> dict:
    """Run cell ``name`` and return its result line as a dict, ``checks``
    last. ``spec_patch`` and ``mix_patch`` override sizes of the
    configuration and the traffic, ``limits`` the configuration's limits
    (the CPU tests' small runs)."""
    cell = man.cell(name)
    spec = dict(man.config(cell["config"]), **(spec_patch or {}))
    mix = dict(man.traffic(cell["traffic"]), **(mix_patch or {}))
    ref = man.reference(spec)
    rec, lb = run_cell(spec, mix, ref, seed, seconds, trace, t_process,
                       device=device)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(name, kind):
        v = man.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    counts = check.orchestrator(rec)
    gap = check.served_gap(rec, ref, seed, lb.device)
    lim = dict(spec["limits"], **(limits or {}))
    checks = {k: {"value": gap[k], "limit": lim[k]} for k in GAPS}
    checks.update({k: {"value": v, "limit": 0} for k, v in counts.items()})
    # a limit not yet set (null) passes nothing
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values()) and gap["tokens"] > 0
    failed = counts["missing"] + counts["bad_tokens"]
    dev = {"platform": "gpu" if lb.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(lb.device)
           if lb.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": rec.attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev.update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["sample"] = gap
    out["counts"] = counts_line(rec)
    out["checks"] = checks
    out["_record"] = rec
    return out


def counts_line(rec) -> dict:
    """What the window carried: steps, slots active a step, tokens,
    invocations, creations, the DES seconds it covered."""
    steps = rec.steps_in_window()
    n = len(steps)
    return {"window_s": rec.window_s, "loop_s": rec.w_stop - rec.w0,
            "steps": n,
            "active_per_step": sum(r[2] for r in steps) / n if n else 0,
            "tokens": sum(r[3] for r in steps),
            "completed": rec.completed_in_window,
            "creations": rec.creations_in_window,
            "des_s": rec.des_s}


def emit(out: dict) -> None:
    """The check lines on standard error, then the result line last on
    standard output."""
    out = {k: v for k, v in out.items() if k != "_record"}
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
