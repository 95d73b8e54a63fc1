"""Process-global warm-state cache for live-mode replicas.

The live analogue of the paper's sandbox-churn insight: Dirigent makes
sandbox *creation* cheap by keeping the expensive state out of the
per-creation critical path. PyTorch runs eagerly, so there is no compiled
executable to share; what a first replica of a configuration pays and a
later one must not pay again is

  * building and loading the hand-written kernel library
    (``repro_torch.kernels.build``), CUDA context and cuBLAS handle
    creation and the allocator's first growth — all paid inside the first
    decode step of a signature, which ``warm()`` runs once and times with a
    device synchronise before the clock is read;
  * the module skeleton: a parameter-free (``meta`` device) ``DecoderLM``
    that every replica of the entry clones and materialises.

Keying is ``(ArchConfig, RunConfig, mode)`` as in the reference — both are
frozen dataclasses, so they hash structurally — plus a per-entry ``shapes``
table of the decode signatures ``(ShapeSpec, device type)`` that have been
warmed. ``compiled_executables()`` counts those signatures: a second
replica of one configuration adds zero.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from repro_torch.compat import DeviceLike, resolve_device, sync
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.api import RunConfig, build_model


@dataclass
class CacheEntry:
    """One (arch, run_cfg, mode) entry: shared skeleton + warmed shapes."""

    cfg: ArchConfig
    run_cfg: RunConfig
    mode: str
    model: object = None           # parameter-free skeleton (meta device)
    # (ShapeSpec, device type) -> wall seconds of the warming decode step
    shapes: Dict[Tuple[ShapeSpec, str], float] = field(default_factory=dict)

    def instantiate(self, device: torch.device):
        """A fresh module of this entry with uninitialised parameters on
        ``device`` (the per-replica state)."""
        return copy.deepcopy(self.model).to_empty(device=device)

    def compiled_executables(self) -> int:
        """Decode signatures warmed so far (the regression-test
        observable: a second replica must not add one)."""
        return len(self.shapes)


class ExecutableCache:
    """LRU cache of per-configuration warm state, shared process-wide.

    ``capacity`` bounds the number of distinct (cfg, run_cfg, mode) entries
    (None = unbounded). Hit/miss counters feed the
    ``dirigent_live_exec_cache_*`` metrics.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
            mode: str = "process") -> CacheEntry:
        """Return the shared entry for (cfg, run_cfg, mode), building the
        skeleton on first use."""
        run_cfg = run_cfg or RunConfig()
        key = (cfg, run_cfg, mode)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return entry
            self.misses += 1
            entry = CacheEntry(cfg=cfg, run_cfg=run_cfg, mode=mode,
                               model=build_model(cfg, run_cfg, device="meta"))
            self._entries[key] = entry
            if self.capacity is not None:
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
            return entry

    def warm(self, cfg: ArchConfig, shape: ShapeSpec,
             run_cfg: Optional[RunConfig] = None, mode: str = "process",
             model=None, device: DeviceLike = None) -> float:
        """Run one decode step of ``shape`` (batch = ``shape.global_batch``,
        cache length ``shape.seq_len``, per-slot lengths) so that everything
        a first step pays — kernel build and load, library handles, the
        allocator's growth — is paid now, and record its wall time under the
        entry. Returns the seconds spent, 0.0 when the signature was warmed
        before. ``model`` is a materialised module to run it on (a replica's
        own); without one a throw-away module is drawn from seed 0."""
        device = model.device if model is not None else resolve_device(device)
        entry = self.get(cfg, run_cfg, mode)
        key = (shape, device.type)
        if key in entry.shapes:
            return 0.0
        if model is None:
            model = entry.instantiate(device).init_params(
                torch.Generator(device=device).manual_seed(0))
        b = shape.global_batch
        batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32,
                                       device=device),
                 "cache_len": torch.zeros((b,), dtype=torch.int32,
                                          device=device)}
        sync(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            cache = model.init_cache(shape, batch=b)
            model.decode_step(cache, batch)
        sync(device)
        dt = time.perf_counter() - t0
        entry.shapes[key] = dt
        return dt

    def compiled_executables(self) -> int:
        return sum(e.compiled_executables() for e in self._entries.values())

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "compiled_executables": self.compiled_executables()}


# -- the process-global default ------------------------------------------------
_DEFAULT: Optional[ExecutableCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> ExecutableCache:
    """The process-global cache every Replica shares unless told otherwise."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExecutableCache()
        return _DEFAULT


def reset_default_cache() -> ExecutableCache:
    """Swap in a fresh global cache (tests measuring cold creations)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = ExecutableCache()
        return _DEFAULT
