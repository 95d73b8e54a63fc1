"""Serving launcher: a Dirigent cluster fronting real model replicas.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 24 [--rate 4] [--hedge 0.5] [--device cuda|cpu]

Counterpart of ``repro.launch.serve``, with the same arguments (plus
``--device``, default ``cuda``) and printed lines: the full orchestration
stack in live mode (control plane, data planes, workers), the model
(reduced, as there) registered as a Function, an open-loop stream of
prompts through the front-end LB, per-request latency and the
autoscaler's cold starts.

One difference, on purpose (ROADMAP §C7): the reference runs every payload
on ``next(iter(replicas.values()))``, whichever replica was made first.
Here each invocation carries a ``LiveRequest`` that the worker hands to
the replica of the sandbox the data plane picked (``LiveBackend``, process
mode), and the backend's teardown hook frees a replica when the
autoscaler reclaims its sandbox. Each sandbox's replica draws its weights
from its sandbox id, so a request's tokens show which replica served it.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import Cluster, Function, ScalingConfig
from repro_torch.core.request import LiveRequest
from repro_torch.live import LiveBackend, LiveFunctionSpec
from repro_torch.simcore import Environment

MAX_SEQ = 128


class DispatchRecord(LiveBackend):
    """A ``LiveBackend`` that remembers which sandbox each request was
    admitted to."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.sandbox_of = {}

    def admit(self, sandbox_id, req):
        ticket = super().admit(sandbox_id, req)
        self.sandbox_of[id(req)] = sandbox_id
        return ticket


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="virtual-time requests/s")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--hedge", type=float, default=None,
                    help="straggler hedge timeout (s), None = off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch).reduced(
        n_layers=4, d_model=128, n_heads=4, d_ff=256, vocab=1024)
    backend = DispatchRecord(
        default_spec=LiveFunctionSpec(cfg=cfg, max_seq=MAX_SEQ, max_slots=1,
                                      default_max_new=args.max_new),
        device=args.device)
    env = Environment(seed=args.seed)
    cluster = Cluster(env, n_workers=args.workers, runtime="firecracker",
                      live_backend=backend, hedge_after=args.hedge)
    cluster.start()
    cluster.register_sync(Function(
        name=cfg.name, image_url=f"registry://{cfg.name}", port=9000,
        scaling=ScalingConfig(target_concurrency=1, stable_window=120,
                              scale_to_zero_grace=120)))
    print(f"[serve] {cfg.name} registered; {args.workers} workers")

    rng = np.random.default_rng(args.seed)
    invs = []
    t_wall = time.perf_counter()

    def driver(env):
        for _ in range(args.requests):
            prompt = rng.integers(1, cfg.vocab,
                                  size=rng.integers(2, 8)).tolist()
            invs.append(cluster.invoke(
                cfg.name, exec_time=0.05, request=LiveRequest(
                    prompt=prompt, max_new_tokens=args.max_new)))
            yield env.timeout(1.0 / args.rate)

    env.process(driver(env), name="driver")
    env.run(until=args.requests / args.rate + 60.0)
    wall = time.perf_counter() - t_wall
    backend.close()

    ok = [i for i in invs if not i.failed and i.t_done > 0]
    lats = np.array([i.e2e_latency for i in ok])
    cold = sum(1 for i in ok if i.cold)
    toks = sum(len(i.request.tokens) for i in ok if i.request.tokens)
    print(f"[serve] {len(ok)}/{len(invs)} ok; {cold} cold starts; "
          f"{cluster.collector.sandbox_creations} replicas; {toks} tokens")
    print(f"[serve] e2e virtual-time: p50 {np.percentile(lats, 50)*1e3:.0f} ms "
          f"p99 {np.percentile(lats, 99)*1e3:.0f} ms; wall {wall:.1f}s")
    return {"cfg": cfg, "invocations": invs, "ok": len(ok),
            "backend": backend, "wall_s": wall,
            "replicas": cluster.collector.sandbox_creations}


if __name__ == "__main__":
    main()
