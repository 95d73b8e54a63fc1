"""The arithmetic of the metrics read from the program's own spans
(``repro_torch.trace``), on a run's ``cell.Record``: its set-up
[``w0 - setup_s``, ``w0``] is on the clock the spans are read on
(``time.perf_counter``). The creation's spans are recorded always. A
program without them (no ``repro_torch.trace``) gives None, and the metric
is left out."""
from __future__ import annotations

from typing import Optional

KERNELS = "backend.kernels.load"    # the kernel library's first build, load


def program_spans() -> list:
    try:
        from repro_torch import trace
    except ImportError:
        return []
    return trace.spans()


def _in_setup(rec, name: str) -> Optional[float]:
    """Summed seconds of the spans called ``name`` that end in the set-up,
    each less its ``KERNELS`` child."""
    spans = program_spans()
    kernels = {id(s.parent): s.seconds for s in spans
               if s.name == KERNELS and s.parent is not None}
    s0 = rec.w0 - rec.setup_s
    got = [s.seconds - kernels.get(id(s), 0.0) for s in spans
           if s.name == name and s0 <= s.end <= rec.w0]
    return sum(got) if got else None


def create_warm_s(rec) -> Optional[float]:
    """Seconds of the decode step's eager warm-up steps (``backend.warm``)
    in the set-up, their device work included; the kernel library's build
    and load, which the process's first warm-up holds, left out."""
    return _in_setup(rec, "backend.warm")


def create_capture_s(rec) -> Optional[float]:
    """Seconds of the decode step's capture into a CUDA graph
    (``backend.capture``) in the set-up."""
    return _in_setup(rec, "backend.capture")
