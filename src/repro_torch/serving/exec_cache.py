"""Process-global warm-state cache for live-mode replicas, and the captured
decode executable each replica runs.

The live analogue of the paper's sandbox-churn insight: Dirigent makes
sandbox *creation* cheap by keeping the expensive state out of the
per-creation critical path, and every step then runs one prepared program.
The reference keeps ``jax.jit(model.decode_step)`` in its entry and
compiles it per signature in ``warm()``. On CUDA the counterpart of a
compiled program is a captured CUDA graph: ``DecodeExecutable`` records one
decode step of a model into a graph and replays it. A graph binds
addresses (the replica's parameters and one cache), so unlike an XLA
executable it cannot be shared between replicas, nor between two users of
one replica: an executable owns the cache it was captured on, and a
replica has one per (signature, user of a cache): the one ``warm`` builds,
and a fresh one for each further cache it hands out (``Replica.new_cache``).

What a first replica of a configuration pays and a later one does not:

  * building and loading the hand-written kernel library
    (``repro_torch.kernels.build``), CUDA context and cuBLAS handle
    creation and the allocator's first growth, all paid inside the first
    eager step of a signature;
  * the module skeleton: a parameter-free (``meta`` device) model that
    every replica of the entry clones and materialises.

What every replica pays once per signature, at creation: its own capture
(``WARM_STEPS`` eager steps, then the capture). ``warm()`` does both; their
seconds are those of their spans (``backend.warm``, ``backend.capture``).

Keying is ``(ArchConfig, RunConfig, mode)`` as in the reference (frozen
dataclasses, so they hash structurally), plus a per-entry ``shapes`` table
of the decode signatures ``(cache length, batch, device type)`` that have
been warmed. ``compiled_executables()`` counts those signatures, as the
reference counts its jit's traces: a second replica of one configuration,
or a second cache of one replica, adds zero. ``stats()["captured_graphs"]``
counts the graphs alive, every executable of a signature included.
"""
from __future__ import annotations

import copy
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.compat import DeviceLike, resolve_device, sync, warm_stream
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.api import RunConfig, build_model

# eager steps before a capture: the first pays the lazy set-up, the last
# runs under CUDA's sync debug mode "error", so a step that reads the
# device on the host raises there, naming its op, instead of being captured
WARM_STEPS = 2


def _host(x) -> np.ndarray:
    """A host-side value (int, list, numpy array, tensor) as numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DecodeExecutable:
    """One model's decode step at one signature (batch, cache length), run
    on static buffers: tokens ``(B, 1)`` and ``cache_len`` ``(B,)`` int32
    on the model's device, the cache, and the logits the step returns.

    A call stages host inputs into the buffers and runs the step: on a CUDA
    device by replaying the graph ``capture()`` recorded (through pinned
    buffers and ``non_blocking`` copies on the current stream), on the CPU
    (the tests) by running ``decode_step`` eagerly on the same buffers. A
    CUDA executable that was not captured raises: it never decodes
    eagerly. The logits are the static output, overwritten by the next
    call: a caller consumes them first. The executable holds its model
    weakly (the replica owns it)."""

    def __init__(self, model, shape: ShapeSpec):
        self._model = weakref.ref(model)
        self.who = type(model).__name__
        self.device = model.device
        self.batch = b = shape.global_batch
        # Zamba2 writes its caches at one position for the whole batch
        self.one_length = not getattr(model, "per_row_lengths", True)
        with torch.inference_mode():
            self.tokens = torch.zeros((b, 1), dtype=torch.int32,
                                      device=self.device)
            self.cache_len = torch.zeros((b,), dtype=torch.int32,
                                         device=self.device)
            self.cache = model.init_cache(shape, batch=b)
        self.logits: Optional[torch.Tensor] = None
        self.graph = None
        self.replay_counts: Dict[str, int] = {}   # launches of one replay
        self.warm_steps = self.replays = self.eager_steps = 0
        # seconds of the warm-up steps (their device work included) and of
        # the capture, from the clock readings of their spans
        self.warm_s: Optional[float] = None
        self.capture_s: Optional[float] = None
        if self.device.type == "cuda":
            self._pinned_tokens = torch.zeros((b, 1), dtype=torch.int32,
                                              pin_memory=True)
            self._pinned_lens = torch.zeros((b,), dtype=torch.int32,
                                            pin_memory=True)
            self._copied = torch.cuda.Event()

    @property
    def model(self):
        model = self._model()
        if model is None:
            raise RuntimeError(f"the {self.who} of this decode executable "
                               "is gone")
        return model

    # -- the step ----------------------------------------------------------
    def _step(self) -> torch.Tensor:
        """One decode step on the static buffers (the body a graph holds).
        The lengths were checked on the host (``__call__``)."""
        with L.lengths_checked():
            logits, _ = self.model.decode_step(
                self.cache, {"tokens": self.tokens,
                             "cache_len": self.cache_len})
        return logits

    def reset(self) -> None:
        """Zero the cache (what ``init_cache`` returns), outside any graph."""
        with torch.inference_mode():
            for t in self.cache.values():
                t.zero_()

    def warm(self, steps: int = WARM_STEPS) -> None:
        """``steps`` eager steps from the zeroed cache, then on a CUDA device
        the capture; the cache is zeroed after (the steps advanced it)."""
        with torch.inference_mode():
            if self.device.type == "cuda":
                self._capture(steps)
            else:
                with trace.Span("backend.warm") as sp:
                    for _ in range(steps):
                        self._step()
                self.warm_s = sp.seconds
                self.warm_steps += steps
        self.reset()

    def _capture(self, steps: int) -> None:
        """The eager steps on a side stream, the last under sync debug mode
        "error", then the capture into a graph with its own memory pool.
        Launches the wrappers counted during the capture are taken back (a
        capture is not a run) and kept as what a replay launches."""
        side = warm_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with trace.Span("backend.warm") as sp:
            with torch.cuda.stream(side):
                for i in range(steps):
                    if i < steps - 1:
                        self._step()
                        continue
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        self._step()
                    except RuntimeError as e:
                        raise RuntimeError(
                            f"{self.who}.decode_step reads the device on "
                            f"the host, so it cannot be captured: {e}") \
                            from e
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            # the steps' device work belongs to the warm-up (the capture
            # would wait for it first)
            sync(self.device)
        self.warm_s = sp.seconds
        self.warm_steps += steps
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with trace.Span("backend.capture") as sp:
            try:
                with torch.cuda.graph(graph):
                    logits = self._step()
            except Exception as e:
                raise RuntimeError(f"{self.who}.decode_step could not be "
                                   f"captured as a CUDA graph: {e}") from e
            finally:
                counted = ops.launch_delta(before)
                ops.add_launches(counted, times=-1)
        self.capture_s = sp.seconds
        self.replay_counts = counted
        self.graph, self.logits = graph, logits

    # -- a call ------------------------------------------------------------
    def _stage(self, tokens: np.ndarray, lens: np.ndarray) -> None:
        if self.device.type != "cuda":
            self.tokens.copy_(torch.from_numpy(tokens))
            self.cache_len.copy_(torch.from_numpy(lens))
            return
        if not self._copied.query():
            # the last call's copies still read the pinned buffers
            self._copied.synchronize()
        self._pinned_tokens.numpy()[:] = tokens
        self._pinned_lens.numpy()[:] = lens
        self.tokens.copy_(self._pinned_tokens, non_blocking=True)
        self.cache_len.copy_(self._pinned_lens, non_blocking=True)
        self._copied.record()

    def __call__(self, tokens, cache_len) -> torch.Tensor:
        """tokens (B, 1) and cache_len (a scalar or (B,)), host values ->
        logits (B, V), the static output."""
        tok = _host(tokens).astype(np.int32).reshape(self.batch, 1)
        lens = np.array(np.broadcast_to(
            _host(cache_len).astype(np.int32).reshape(-1), (self.batch,)))
        if self.one_length:
            L.check_one_length(lens, self.who)
        with torch.inference_mode():
            with trace.step("batcher.stage"):
                self._stage(tok, lens)
            if self.graph is not None:
                with trace.step("batcher.replay", timed=True):
                    self.graph.replay()
                ops.add_launches(self.replay_counts)
                self.replays += 1
                return self.logits
            if self.device.type != "cpu":
                raise RuntimeError(
                    f"{self.who}: this decode executable on {self.device} "
                    "was not captured (ExecutableCache.warm captures it); "
                    "a CUDA replica never decodes eagerly")
            with trace.step("batcher.replay"):
                logits = self._step()
            self.eager_steps += 1
            if self.logits is None:
                self.logits = logits
            else:
                self.logits.copy_(logits)
            return self.logits


@dataclass
class CacheEntry:
    """One (arch, run_cfg, mode) entry: shared skeleton, warmed signatures,
    and each live replica model's executables."""

    cfg: ArchConfig
    run_cfg: RunConfig
    mode: str
    model: object = None           # parameter-free skeleton (meta device)
    # (cache length, batch, device type) -> seconds of its first warm-up
    # and capture
    shapes: Dict[Tuple[int, int, str], float] = field(default_factory=dict)
    # replica model -> {(cache length, batch): its DecodeExecutables}, the
    # first the one ``warm`` built, each later one a cache of its own; held
    # weakly, so a replica's graphs and caches go with it
    executables: "weakref.WeakKeyDictionary" = field(
        default_factory=weakref.WeakKeyDictionary)

    def instantiate(self, device: torch.device):
        """A fresh module of this entry with uninitialised parameters on
        ``device`` (the per-replica state)."""
        return copy.deepcopy(self.model).to_empty(device=device)

    def executable(self, model, shape: ShapeSpec
                   ) -> Optional[DecodeExecutable]:
        """``model``'s first executable of ``shape`` (the warmed one)."""
        exes = self.executables.get(model, {}).get(
            (shape.seq_len, shape.global_batch))
        return exes[0] if exes else None

    def compiled_executables(self) -> int:
        """Decode signatures warmed so far (the regression-test
        observable: a second replica must not add one)."""
        return len(self.shapes)

    def captured_graphs(self) -> int:
        return sum(exe.graph is not None
                   for by_shape in list(self.executables.values())
                   for exes in by_shape.values() for exe in exes)


class ExecutableCache:
    """LRU cache of per-configuration warm state, shared process-wide.

    ``capacity`` bounds the number of distinct (cfg, run_cfg, mode) entries
    (None = unbounded). Hit/miss counters feed the
    ``dirigent_live_exec_cache_*`` metrics; ``warm_steps`` counts the eager
    steps every warm ran (a kernel launch check adds them to the replays).
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.warm_steps = 0

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

    def _warm(self, cfg, shape, run_cfg, mode, model, device, fresh=False):
        device = model.device if model is not None else resolve_device(device)
        entry = self.get(cfg, run_cfg, mode)
        key = (shape.seq_len, shape.global_batch, device.type)
        new = key not in entry.shapes
        if not new and not fresh and (
                model is None or entry.executable(model, shape) is not None):
            return entry, 0.0, None
        if model is None:
            model = entry.instantiate(device).init_params(
                torch.Generator(device=device).manual_seed(0))
        exe = DecodeExecutable(model, shape)
        exe.warm()
        self.warm_steps += exe.warm_steps
        entry.executables.setdefault(model, {}).setdefault(
            (shape.seq_len, shape.global_batch), []).append(exe)
        if not new:
            return entry, 0.0, exe
        dt = entry.shapes[key] = exe.warm_s + (exe.capture_s or 0.0)
        return entry, dt, exe

    def warm(self, cfg: ArchConfig, shape: ShapeSpec,
             run_cfg: Optional[RunConfig] = None, mode: str = "process",
             model=None, device: DeviceLike = None) -> float:
        """Build ``model``'s decode executable of ``shape`` (batch =
        ``shape.global_batch``, cache length ``shape.seq_len``): eager
        steps, then on a CUDA device the capture, the counterpart of the
        reference's trace and compile. Returns the seconds of the warm-up
        and capture (their spans') when the signature is new to the entry,
        else 0.0: a later replica still captures its own graph here (billed
        to its creation by the caller's clock), but its creation is not
        cold. ``model`` is a materialised
        module (a replica's own); without one a throw-away module drawn
        from seed 0 warms the signature and is dropped with its graph."""
        return self._warm(cfg, shape, run_cfg, mode, model, device)[1]

    def executable(self, cfg: ArchConfig, shape: ShapeSpec,
                   run_cfg: Optional[RunConfig] = None,
                   mode: str = "process", *, model,
                   fresh: bool = False) -> DecodeExecutable:
        """``model``'s first decode executable of ``shape``, warmed first if
        it has none; with ``fresh``, a new one beside those it has (its own
        cache, warmed and on a CUDA device captured; the signature is not
        new, so ``compiled_executables`` does not move)."""
        entry, _, exe = self._warm(cfg, shape, run_cfg, mode, model, None,
                                   fresh)
        return exe if fresh else entry.executable(model, shape)

    def compiled_executables(self) -> int:
        return sum(e.compiled_executables() for e in self._entries.values())

    def captured_graphs(self) -> int:
        return sum(e.captured_graphs() for e in self._entries.values())

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "compiled_executables": self.compiled_executables(),
                "captured_graphs": self.captured_graphs()}


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
