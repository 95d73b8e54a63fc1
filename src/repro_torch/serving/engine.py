"""Serving engine: the compute payload a Dirigent "sandbox" hosts.

Two layers:

  * ``Replica`` — one model instance on one device, greedy or temperature
    sampling, simple per-request ``generate``. Every decode step runs
    through the replica's ``DecodeExecutable`` of its batch size
    (``serving/exec_cache.py``): on a CUDA device a replay of the captured
    graph of ``decode_step``, the counterpart of the reference's
    ``jax.jit``; on the CPU the same step run eagerly on the same static
    buffers. The executable owns the cache, and each user of a cache gets
    one of its own, as the reference's ``new_cache`` builds a fresh cache
    on every call: ``new_cache(b)`` hands out (zeroed) the cache of the
    executable ``ExecutableCache.warm`` built for batch ``b`` the first
    time, and later the cache of a fresh executable (warmed and captured
    then); ``generate`` decodes on a batch-1 executable that no
    ``new_cache`` hands out. This is what the live-mode worker hook
    instantiates per sandbox.
  * ``ContinuousBatcher`` — slot-based continuous batching on top of a
    Replica: a fixed (max_slots, max_seq) KV cache; new requests are admitted
    into free slots mid-flight and their prompts are consumed token-by-token
    while other slots generate (decode-only lockstep, per-slot cache
    lengths). This is the data-plane concurrency-throttling analogue: the
    sandbox advertises ``max_slots`` as its concurrency capacity to the
    Dirigent DP.

Sampling and the batcher's argmax run outside the captured step, as the
reference's ``sample_token`` is a call of its own. Every model call runs
under ``torch.inference_mode()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch import trace
from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.api import RunConfig
from repro_torch.serving.exec_cache import (DecodeExecutable, ExecutableCache,
                                            default_cache)


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32. Greedy at ``temperature <= 0``; else a
    categorical draw per row from ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class Replica:
    def __init__(self, cfg: ArchConfig, params=None, rng_seed: int = 0,
                 max_seq: int = 256, run_cfg: Optional[RunConfig] = None,
                 exec_cache: Optional[ExecutableCache] = None,
                 device: DeviceLike = None):
        """``device=None`` means the GPU and raises without one. ``params``
        is a state_dict to load; without it the weights are drawn from a
        ``torch.Generator`` seeded with ``rng_seed`` on ``device``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_cfg = run_cfg or RunConfig(q_chunk=64, kv_chunk=64,
                                            seq_chunk=16)
        # the skeleton and the warmed decode signatures come from the shared
        # process-global cache: the second replica of a (cfg, run_cfg) pays
        # model-state construction and its own capture only
        # (serving/exec_cache.py)
        self.exec_cache = exec_cache if exec_cache is not None \
            else default_cache()
        self.entry = self.exec_cache.get(cfg, self.run_cfg)
        self.model = self.entry.instantiate(self.device)
        self.max_seq = max_seq
        if params is None:
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(rng_seed))
        else:
            self.model.load_state_dict(params)
        self.stats = {"requests": 0, "tokens": 0, "decode_steps": 0}
        # batch -> its executables, the first the warmed one
        self._executables: Dict[int, List[DecodeExecutable]] = {}
        self._taken: Set[DecodeExecutable] = set()   # a user holds its cache
        self._generate_exe: Optional[DecodeExecutable] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def _shape(self, batch: int) -> ShapeSpec:
        return ShapeSpec("serve", self.max_seq, batch, "decode")

    def executable(self, batch: int) -> DecodeExecutable:
        """The first decode executable of ``batch`` rows at ``max_seq``
        (the one ``ExecutableCache.warm`` builds), warmed (and on a CUDA
        device captured) through the cache on first use."""
        exes = self._executables.get(batch)
        if not exes:
            exes = self._executables[batch] = [self.exec_cache.executable(
                self.cfg, self._shape(batch), self.run_cfg, model=self.model)]
        return exes[0]

    def _take(self, batch: int) -> DecodeExecutable:
        """An executable of ``batch`` rows whose cache no user holds: the
        first, unless a user took it, else a fresh one (warmed, and on a
        CUDA device captured, now)."""
        exe = self.executable(batch)
        if exe in self._taken:
            exe = self.exec_cache.executable(
                self.cfg, self._shape(batch), self.run_cfg, model=self.model,
                fresh=True)
            self._executables[batch].append(exe)
        self._taken.add(exe)
        return exe

    def _decode(self, cache, batch):
        """One step on ``cache``, which must come from ``new_cache`` with
        that batch size: -> (logits, cache). The logits are the
        executable's static output, overwritten by its next step."""
        for exe in self._executables.get(len(batch["tokens"]), ()):
            if cache is exe.cache:
                return exe(batch["tokens"], batch["cache_len"]), exe.cache
        raise ValueError("a replica decodes on the cache its executable "
                         "owns: take it from new_cache()")

    def new_cache(self, batch: int):
        """A zeroed cache of ``batch`` rows that no other user holds, owned
        by an executable of this replica."""
        exe = self._take(batch)
        exe.reset()
        return exe.cache

    def generate(self, prompt_tokens: List[int], max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0) -> List[int]:
        """Single-request generation (prompt consumed via decode steps) on
        a batch-1 executable of its own, whose cache is zeroed first."""
        if self._generate_exe is None:
            self._generate_exe = self._take(1)
        exe = self._generate_exe
        exe.reset()
        toks = list(prompt_tokens)
        out: List[int] = []
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits = None
        for t, tok in enumerate(toks):
            logits = exe([[tok]], t)
            self.stats["decode_steps"] += 1
        pos = len(toks)
        for _ in range(max_new_tokens):
            nxt = int(sample_token(logits, gen, temperature)[0])
            out.append(nxt)
            logits = exe([[nxt]], pos)
            self.stats["decode_steps"] += 1
            pos += 1
        self.stats["requests"] += 1
        self.stats["tokens"] += len(out)
        return out


@dataclass
class Slot:
    active: bool = False
    request_id: int = -1
    pending: List[int] = field(default_factory=list)   # prompt not yet fed
    generated: List[int] = field(default_factory=list)
    length: int = 0
    max_new: int = 0


class ContinuousBatcher:
    """Decode-only continuous batching with per-slot cache lengths."""

    def __init__(self, replica: Replica, max_slots: int = 8):
        self.replica = replica
        self.max_slots = max_slots
        self.slots = [Slot() for _ in range(max_slots)]
        self.cache = replica.new_cache(max_slots)
        self._next_id = 0
        self.finished: Dict[int, List[int]] = {}
        self.steps = 0

    @property
    def free_slots(self) -> int:
        return sum(1 for s in self.slots if not s.active)

    def add_request(self, prompt: List[int], max_new: int = 16) -> int:
        for slot in self.slots:
            if not slot.active:
                rid = self._next_id
                self._next_id += 1
                slot.active = True
                slot.request_id = rid
                slot.pending = list(prompt)
                slot.generated = []
                slot.length = 0
                slot.max_new = max_new
                return rid
        raise RuntimeError("no free slot (throttle at the data plane)")

    def step(self) -> List[int]:
        """One lockstep decode over all slots; returns finished request ids.
        Inactive slots are stepped too, with token 0 at length 0: they write
        row 0 of their own cache rows and attend over one position."""
        if all(not s.active for s in self.slots):
            return []
        with trace.step("batcher.step"):
            tokens = np.zeros((self.max_slots, 1), np.int32)
            lens = np.zeros((self.max_slots,), np.int32)
            for i, s in enumerate(self.slots):
                lens[i] = s.length
                if not s.active:
                    continue
                if s.pending:
                    tokens[i, 0] = s.pending.pop(0)
                else:
                    tokens[i, 0] = (s.generated[-1] if s.generated else 0)
            batch = {"tokens": tokens, "cache_len": lens}
            logits, self.cache = self.replica._decode(self.cache, batch)
            self.steps += 1
            # the device->host copy of the argmax synchronises with the
            # device
            with trace.step("batcher.read"):
                argmax = torch.argmax(logits, dim=-1).cpu().numpy()
            done: List[int] = []
            for i, s in enumerate(self.slots):
                if not s.active:
                    continue
                s.length += 1
                if s.pending:
                    continue               # still consuming the prompt
                s.generated.append(int(argmax[i]))
                if (len(s.generated) >= s.max_new
                        or s.length >= self.replica.max_seq - 1):
                    self.finished[s.request_id] = s.generated
                    done.append(s.request_id)
                    s.active = False
        return done

    def abort(self) -> List[int]:
        """Kill every in-slot request without finishing it (node-failure
        semantics; graceful teardown drains via ``run_until_done`` instead,
        mirroring the DES ``teardown_drain_grace``). Aborted requests never
        appear in ``finished``; returns their request ids."""
        killed: List[int] = []
        for s in self.slots:
            if s.active:
                killed.append(s.request_id)
                s.active = False
                s.pending = []
                s.generated = []
        return killed

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if all(not s.active for s in self.slots):
                break
            self.step()
        return self.finished
