"""LiveBackend: dual-mode sandbox payloads behind the DES orchestrator.

Execution mode is selected per function by ``LiveFunctionSpec.mode``:

  * ``process``   — the sandbox is an in-process ``Replica`` +
    ``ContinuousBatcher`` on the backend's device. A creation after the
    first pays model-state construction only (params + KV cache): the kernel
    library, the library handles and the warmed decode signature come from
    the process-global ``ExecutableCache`` — the live analogue of a snapshot
    restore against pre-created state.
  * ``container`` — an isolated subprocess worker per sandbox. Not ported
    yet: it raises ``NotImplementedError`` (ROADMAP: container mode).

Wiring into the DES (all hooks are no-ops unless a backend is installed —
the default path stays bit-identical):

  * ``create_hook(sandbox)``   — called by ``WorkerDaemon.create_sandbox``
    after the modeled boot; builds the replica, logs cold/warm wall time.
  * ``teardown_hook(sid, drain=True)`` — called by
    ``WorkerDaemon.kill_sandbox`` (drain: in-slot requests finish first,
    matching the DES ``teardown_drain_grace`` semantics) and by
    ``fail_node`` (drain=False: in-slot requests fail).
  * ``admit``/``collect``      — the invoke path. ``WorkerDaemon.execute``
    admits the invocation's ``LiveRequest`` into the target sandbox's
    batcher *before* yielding its dispatch-overhead timeout, so requests
    that are concurrent in sim time land in slots together and share
    decode steps; ``collect`` then pumps the batcher until the request's
    slot finishes, billing only the wall time this request actually spent
    pumping (work done while pumping for a neighbour is the batching win).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compat import DeviceLike, resolve_device, sync
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.request import LiveRequest
from repro_torch.models.api import RunConfig


@dataclass(frozen=True)
class LiveFunctionSpec:
    """Per-function live-execution config (the ``live_mode`` knobs)."""

    cfg: ArchConfig
    mode: str = "process"            # "process" | "container"
    run_cfg: Optional[RunConfig] = None
    max_seq: int = 64                # replica KV-cache length
    max_slots: int = 4               # batcher slots == DP concurrency
    default_max_new: int = 8         # when a LiveRequest leaves it unset


@dataclass
class LiveTicket:
    """Handle returned by ``admit``; redeemed by ``collect``."""

    sandbox_id: int
    rid: int                         # batcher request id
    request: LiveRequest
    admit_peers: int = 0             # active slots present at admission


class _ProcessSandbox:
    """In-process replica + batcher (mode="process")."""

    def __init__(self, spec: LiveFunctionSpec, exec_cache, seed: int,
                 device):
        from repro_torch.serving.engine import ContinuousBatcher, Replica

        self.spec = spec
        self.replica = Replica(spec.cfg, rng_seed=seed, max_seq=spec.max_seq,
                               run_cfg=spec.run_cfg, exec_cache=exec_cache,
                               device=device)
        self.batcher = ContinuousBatcher(self.replica,
                                         max_slots=spec.max_slots)

    def admit(self, req: LiveRequest) -> Tuple[int, int]:
        """Admit into a free slot; returns (rid, co-resident active slots)."""
        peers = sum(1 for s in self.batcher.slots if s.active)
        rid = self.batcher.add_request(
            list(req.prompt), req.max_new_tokens or self.spec.default_max_new)
        return rid, peers

    def pump(self, rid: int) -> Tuple[Optional[List[int]], int]:
        """Step the shared batcher until ``rid`` finishes; returns (tokens,
        max co-resident active slots seen while pumping)."""
        peers = 0
        while rid not in self.batcher.finished:
            active = sum(1 for s in self.batcher.slots if s.active)
            if active == 0:
                break                # aborted out from under us
            peers = max(peers, active)
            self.batcher.step()
        return self.batcher.finished.get(rid), peers

    def drain(self) -> Dict[int, List[int]]:
        return self.batcher.run_until_done()

    def abort(self) -> List[int]:
        return self.batcher.abort()

    def close(self) -> None:
        pass


class LiveBackend:
    """Owns every live sandbox runtime; plugs into Cluster via hooks."""

    def __init__(self, specs: Optional[Dict[str, LiveFunctionSpec]] = None,
                 default_spec: Optional[LiveFunctionSpec] = None,
                 exec_cache=None, device: DeviceLike = None):
        """``device=None`` means the GPU; without one this raises."""
        from repro_torch.serving.exec_cache import default_cache

        self.specs = dict(specs or {})
        self.default_spec = default_spec
        self.device = resolve_device(device)
        self.exec_cache = exec_cache if exec_cache is not None \
            else default_cache()
        self.sandboxes: Dict[int, object] = {}       # sid -> runtime
        # results that outlive their runtime (graceful teardown drains
        # in-slot requests; their tickets must still collect)
        self._orphaned: Dict[Tuple[int, int], List[int]] = {}
        self._failed_sids: set = set()               # torn down drain=False
        # -- observability (monitoring.render_metrics) ----------------------
        self.start_log: List[dict] = []              # one row per creation
        self.teardowns = 0
        self.invokes = 0
        self.invoke_seconds_total = 0.0
        self.tokens_total = 0
        self.batched_invokes = 0                     # shared >=1 decode step

    # -- config ------------------------------------------------------------
    def spec_for(self, function_name: str) -> LiveFunctionSpec:
        spec = self.specs.get(function_name, self.default_spec)
        if spec is None:
            raise KeyError(f"no LiveFunctionSpec for {function_name!r} "
                           "and no default_spec")
        return spec

    @property
    def replicas_live(self) -> int:
        return len(self.sandboxes)

    def cache_stats(self) -> dict:
        return self.exec_cache.stats()

    # -- WorkerDaemon hooks --------------------------------------------------
    def create_hook(self, sandbox) -> None:
        """Build the real payload for a freshly booted sandbox. Wall time
        (and whether the warm-state cache was cold) lands in start_log. The
        device is synchronised before the clock is read, or a creation
        whose work is still queued would look free."""
        spec = self.spec_for(sandbox.function_name)
        if spec.mode == "container":
            raise NotImplementedError(
                "container mode (subprocess workers) is not ported yet: "
                "ROADMAP, container mode of live/")
        sync(self.device)
        t0 = time.perf_counter()
        misses0 = self.exec_cache.misses
        rt = _ProcessSandbox(spec, self.exec_cache, seed=sandbox.sandbox_id,
                             device=self.device)
        # bill the first-step costs (kernel build and load, library handles,
        # allocator growth) to creation, not to the first invoke: a cold
        # cache pays them here; a warm one returns at once
        shape = ShapeSpec("live", spec.max_seq, spec.max_slots, "decode")
        warm_s = self.exec_cache.warm(spec.cfg, shape,
                                      run_cfg=rt.replica.run_cfg,
                                      model=rt.replica.model)
        # cold = this creation built the entry OR warmed a new signature
        cold = self.exec_cache.misses > misses0 or warm_s > 0.0
        sync(self.device)
        self.sandboxes[sandbox.sandbox_id] = rt
        self._failed_sids.discard(sandbox.sandbox_id)
        self.start_log.append({
            "sandbox_id": sandbox.sandbox_id,
            "function": sandbox.function_name,
            "mode": spec.mode,
            "cold": cold,
            "wall_s": round(time.perf_counter() - t0, 6),
        })

    def teardown_hook(self, sandbox_id: int, drain: bool = True) -> None:
        """Reclaim a sandbox's replica. drain=True finishes in-slot
        requests first (the DES drain-grace analogue); drain=False fails
        them (node death)."""
        rt = self.sandboxes.pop(sandbox_id, None)
        if rt is None:
            return
        self.teardowns += 1
        if drain:
            for rid, toks in rt.drain().items():
                self._orphaned[(sandbox_id, rid)] = toks
        else:
            rt.abort()
            self._failed_sids.add(sandbox_id)
        rt.close()

    # -- invoke path ---------------------------------------------------------
    def admit(self, sandbox_id: int, req: LiveRequest) -> LiveTicket:
        rt = self.sandboxes.get(sandbox_id)
        if rt is None:
            raise RuntimeError(f"live sandbox {sandbox_id} gone")
        rid, peers = rt.admit(req)
        return LiveTicket(sandbox_id=sandbox_id, rid=rid, request=req,
                          admit_peers=peers)

    def collect(self, ticket: LiveTicket) -> LiveRequest:
        """Run the ticket's request to completion; fills the LiveRequest
        in place and returns it. Wall time spent *here* is what the worker
        bills to the sim clock."""
        req = ticket.request
        t0 = time.perf_counter()
        key = (ticket.sandbox_id, ticket.rid)
        rt = self.sandboxes.get(ticket.sandbox_id)
        toks: Optional[List[int]] = None
        peers = 0
        if key in self._orphaned:                # finished during teardown
            toks = self._orphaned.pop(key)
        elif rt is not None:
            toks, peers = rt.pump(ticket.rid)
        if toks is None:
            req.failed = True
            req.failure_reason = (
                "sandbox failed with request in slot"
                if ticket.sandbox_id in self._failed_sids
                else "request aborted")
        else:
            req.tokens = toks
            # shared decode steps with: slots present when we were admitted
            # (we free-rode on their pump) or co-active while we pumped
            req.batched_with = max(ticket.admit_peers, peers - 1, 0)
            self.tokens_total += len(toks)
            if req.batched_with:
                self.batched_invokes += 1
        req.wall_s = time.perf_counter() - t0
        self.invokes += 1
        self.invoke_seconds_total += req.wall_s
        return req

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Tear down every remaining runtime (bench/test cleanup)."""
        for sid in list(self.sandboxes):
            self.teardown_hook(sid, drain=False)
