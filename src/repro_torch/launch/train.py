"""Training launcher: any assigned architecture on one device, with
checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 100 [--resume] [--grad-accum 4] [--compress] \
        [--device cuda|cpu]

Counterpart of ``repro.launch.train``: the same arguments and printed lines,
plus ``--device`` (default ``cuda``; ``cpu`` runs the same path on the
host). The ``RunConfig`` is built here (q/kv chunk 64, ``seq_chunk`` 16,
``attn_impl="plain"``: gradients pass through the plain attention and
recurrence forms, the kernels have none); the mesh and
``launch/steps.py`` belong to the sharded path (ROADMAP A14), and
``--zero1`` raises until ZeRO-1 is ported (ROADMAP A13). Checkpoints are
written every ``--ckpt-every`` steps in the background and once at the
end; ``--resume`` continues from the newest one, with the same data order
(the stream is indexed by step).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.compat import resolve_device, sync
from repro_torch.configs import get_config
from repro_torch.models.api import RunConfig, build_model
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import ZipfLMStream
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step, trainable


def run_config(grad_accum: int = 1, compress: bool = False) -> RunConfig:
    return RunConfig(attn_impl="plain", q_chunk=64, kv_chunk=64,
                     seq_chunk=16, grad_accum=grad_accum,
                     grad_compress=compress)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 stochastic-rounding gradient codec")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", type=str, default="results/train_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


class Trainer:
    """One model, its optimizer state and data stream on one device: what
    ``main`` drives, and what a caller that wants the step itself (and its
    timings) drives directly."""

    def __init__(self, cfg, run: RunConfig, *, seq: int, batch: int,
                 lr: float, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg, self.seq, self.batch = cfg, seq, batch
        self.model = build_model(cfg, run, device=self.device)
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed))
        self.params = trainable(self.model)
        self.opt = adamw_init(self.params)
        self.step_fn = make_train_step(self.model, lr=lr)
        self.stream = ZipfLMStream(vocab=cfg.vocab, seq=seq, batch=batch,
                                   seed=seed + 1, device=self.device)

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Load a checkpoint into the live parameters and optimizer state;
        returns its step."""
        state, at = restore_checkpoint(ckpt_dir, step, self.state())
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
        self.opt = state["opt"]
        return at

    def step(self, i: int) -> dict:
        """Train step ``i`` on batch ``i`` of the stream, the codec's noise
        from a generator seeded with ``i``."""
        g = torch.Generator(device=self.device).manual_seed(i)
        self.opt, m = self.step_fn(self.opt, self.stream.batch_at(i), g)
        return m


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    if args.zero1:
        raise NotImplementedError(
            "--zero1 (optimizer state sharded over the data axes) is not "
            "ported yet: ROADMAP A13")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, d_ff=384,
                          vocab=2048)
    tr = Trainer(cfg, run_config(args.grad_accum, args.compress),
                 seq=args.seq, batch=args.batch, lr=args.lr, seed=args.seed,
                 device=args.device)
    n = sum(p.numel() for p in tr.params.values())
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params on {tr.device}")

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start = tr.restore(args.ckpt_dir)
        print(f"[train] resumed from step {start}")

    losses, writer = [], None
    t0 = time.time()
    for i in range(start, start + args.steps):
        m = tr.step(i)
        losses.append(float(m["loss"]))
        if (i + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = save_checkpoint(args.ckpt_dir, i + 1, tr.state(),
                                     async_save=True)
        if (i + 1) % 20 == 0:
            sync(tr.device)
            tps = args.batch * args.seq * 20 / (time.time() - t0)
            t0 = time.time()
            print(f"[train] step {i+1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} {tps:,.0f} tok/s")
    if writer is not None:
        writer.join()
    end = start + args.steps
    if end % args.ckpt_every:          # else the last async save holds it
        save_checkpoint(args.ckpt_dir, end, tr.state())
    print(f"[train] done at step {end}")
    return {"start": start, "end": end, "losses": losses, "trainer": tr}


if __name__ == "__main__":
    main()
