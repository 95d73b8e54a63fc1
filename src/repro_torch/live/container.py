"""Container-mode live sandbox: an isolated subprocess replica worker.

Counterpart of ``repro.live.container``. The sandbox is a real OS process
with its own PyTorch runtime (and, on the GPU, its own CUDA context),
started with the ``spawn`` method — ``fork`` would hand the child a copy of
the parent's CUDA context, which it cannot use — and driven over a pipe
with the reference's admit/collect protocol, message for message.

An in-process ``ExecutableCache`` cannot help across process boundaries.
What the first process of a configuration pays and a later one need not is
the ``nvcc`` build of the kernel library, so the shared cache here is the
kernel build directory (``kernels/build.py``): the parent passes
``cache_dir`` and every child sets ``REPRO_TORCH_BUILD_DIR`` to it before
its first kernel launch. A creation is *cold* when the library of the
current sources is not in that directory yet — its child builds it — and
warm when it is, so the child only loads it. On the CPU nothing is ever
built, and cold keeps the reference's meaning: the directory is empty.

The child builds its replica on the device the parent names (the backend's
own, as a string) and never picks one itself: a child that cannot start
there — CUDA asked for on a host without it — answers with the error and
exits, and the creation fails with that cause.

Protocol (parent -> child):
    ("admit", prompt, max_new)   -> ("rid", rid, peers)
    ("collect", rid)             -> ("done", tokens_or_None, peers)
    ("shutdown", drain)          -> ("bye", finished_dict)
Start-up: the child sends ("ready",), or ("error", traceback) and exits.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

# ready-ack budget: a hung child should fail the creation, not the whole
# bench; a dead one is seen at once (the pipe reports end of file)
_READY_TIMEOUT_S = 120.0


def _child_main(conn, spec, cache_dir: Optional[str], seed: int,
                device: str) -> None:
    """Subprocess entry point (module-level: spawn must import it)."""
    try:
        if cache_dir:
            # read by build.build_root() at the first launch, not at import
            os.environ["REPRO_TORCH_BUILD_DIR"] = cache_dir
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.serving.engine import ContinuousBatcher, Replica
        from repro_torch.serving.exec_cache import ExecutableCache

        # fresh per-process cache: isolation is the point of container mode
        cache = ExecutableCache()
        replica = Replica(spec.cfg, rng_seed=seed, max_seq=spec.max_seq,
                          run_cfg=spec.run_cfg, exec_cache=cache,
                          device=device)
        # capture the batcher's decode step before acking ready, so creation
        # wall time includes the kernel build (cold) or its load (warm) and
        # the capture; then one request through the captured step
        cache.warm(spec.cfg, ShapeSpec("live", spec.max_seq, spec.max_slots,
                                       "decode"),
                   run_cfg=replica.run_cfg, model=replica.model)
        batcher = ContinuousBatcher(replica, max_slots=spec.max_slots)
        warm_rid = batcher.add_request([1], 1)
        batcher.run_until_done()
        batcher.finished.pop(warm_rid, None)
    except Exception:
        # the start-up boundary: report the cause to the parent, then exit
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    conn.send(("ready",))
    while True:
        msg = conn.recv()
        if msg[0] == "admit":
            _, prompt, max_new = msg
            peers = sum(1 for s in batcher.slots if s.active)
            rid = batcher.add_request(list(prompt), max_new)
            conn.send(("rid", rid, peers))
        elif msg[0] == "collect":
            rid = msg[1]
            peers = 0
            while rid not in batcher.finished:
                active = sum(1 for s in batcher.slots if s.active)
                if active == 0:
                    break
                peers = max(peers, active)
                batcher.step()
            conn.send(("done", batcher.finished.get(rid), peers))
        elif msg[0] == "shutdown":
            if msg[1]:
                batcher.run_until_done()
            else:
                batcher.abort()
            conn.send(("bye", dict(batcher.finished)))
            break
    conn.close()


def is_cold(cache_dir: Optional[str], device: str) -> bool:
    """Whether a child started now on ``device`` with ``cache_dir`` pays
    the first-process cost: on the GPU, the kernel build (the library of
    the current sources is not in the directory); on the CPU, where nothing
    is built, whether the directory is empty (the reference's rule)."""
    if torch.device(device).type == "cuda":
        return not build.is_built(cache_dir)
    return (not cache_dir) or not os.path.isdir(cache_dir) \
        or not os.listdir(cache_dir)


class ContainerSandbox:
    """Parent-side handle; API mirrors ``_ProcessSandbox``."""

    def __init__(self, spec, cache_dir: Optional[str] = None, seed: int = 0,
                 *, device: str):
        self.spec = spec
        self.cold = is_cold(cache_dir, device)
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self.proc = ctx.Process(
            target=_child_main,
            args=(child_conn, spec, cache_dir, seed, str(device)),
            daemon=True)
        t0 = time.perf_counter()
        self.proc.start()
        child_conn.close()       # the child's end closes when the child dies
        self._wait_ready()
        self.start_wall_s = time.perf_counter() - t0
        self._finished: Dict[int, List[int]] = {}

    def _wait_ready(self) -> None:
        """Return on ("ready",); else stop the child and raise with the
        cause: its traceback, its exit code, or the timeout."""
        answered = self._conn.poll(_READY_TIMEOUT_S)   # True at end of file
        msg: Optional[tuple] = None
        if answered:
            try:
                msg = self._conn.recv()
            except EOFError:     # the child died without a word
                pass
        if msg is not None and msg[0] == "ready":
            return
        self.proc.join(timeout=10.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10.0)
        self._conn.close()
        if msg is not None:
            raise RuntimeError(f"container worker failed to start:\n{msg[1]}")
        if answered:
            raise RuntimeError("container worker exited before it was ready "
                               f"(exit code {self.proc.exitcode})")
        raise RuntimeError("container worker never became ready")

    def admit(self, req) -> Tuple[int, int]:
        self._conn.send(("admit", list(req.prompt),
                         req.max_new_tokens or self.spec.default_max_new))
        _, rid, peers = self._conn.recv()
        return rid, peers

    def pump(self, rid: int) -> Tuple[Optional[List[int]], int]:
        if rid in self._finished:
            return self._finished.pop(rid), 0
        self._conn.send(("collect", rid))
        _, toks, peers = self._conn.recv()
        return toks, peers

    def drain(self) -> Dict[int, List[int]]:
        return self._shutdown(drain=True)

    def abort(self) -> List[int]:
        self._shutdown(drain=False)
        return []

    def _shutdown(self, drain: bool) -> Dict[int, List[int]]:
        finished: Dict[int, List[int]] = {}
        try:
            self._conn.send(("shutdown", drain))
            if self._conn.poll(_READY_TIMEOUT_S):
                msg = self._conn.recv()
                if msg[0] == "bye":
                    finished = msg[1]
        except (BrokenPipeError, EOFError, OSError):
            pass
        self.proc.join(timeout=10.0)
        if self.proc.is_alive():
            self.proc.kill()
        return finished

    def close(self) -> None:
        if self.proc.is_alive():
            self._shutdown(drain=False)
        self._conn.close()
