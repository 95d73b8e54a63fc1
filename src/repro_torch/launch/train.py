"""Training launcher: any assigned architecture, data-parallel over a mesh,
with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 100 [--resume] [--zero1] [--grad-accum 4] \
        [--compress] [--device cuda|cpu] [--eager]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --zero1

Counterpart of ``repro.launch.train``: the same arguments and printed lines,
plus ``--device`` (default ``cuda``; ``cpu`` runs the same path on the
host) and ``--eager``. On one CUDA rank the step is captured as a CUDA
graph and replayed (``train_step.TrainExecutable``), as the reference jits
it; a mesh above one rank, the MoE family and ``--compress`` stay eager
(``train_step.eager_reason``), as does the CPU, where there is nothing to
capture; ``--eager`` asks for eager steps where the rule would capture.
The loss is read on the host every 20 steps and at the end, as the
reference reads it. The mesh is the reference's ``make_local_mesh()``: ``(world, 1)``
over the default process group, which this launcher initialises over gloo
from ``torchrun``'s environment (``env://``), or as a group of one process
(the mesh ``(1, 1)``) when started alone. Each rank trains on its rows of
the batch; ``--zero1`` shards the optimizer's moments over the data axis.
The ``RunConfig`` is built here (q/kv chunk 64, ``seq_chunk`` 16,
``attn_impl="plain"``: gradients pass through the plain attention and
recurrence forms, the kernels have none), as the reference builds its
own rather than going through ``launch/steps.py``. Checkpoints are written every ``--ckpt-every`` steps in the
background and once at the end, by rank 0, with every leaf gathered to its
global shape; ``--resume`` continues from the newest one, onto whatever
mesh this run has, with the same data order (the stream is indexed by
step).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device, sync
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig, build_model
from repro_torch.train.checkpoint import (latest_step, named_shardings,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.data import ZipfLMStream
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (TrainExecutable, eager_reason,
                                          make_train_step, optimizer_pspecs,
                                          trainable)


def run_config(grad_accum: int = 1, compress: bool = False,
               zero1: bool = False) -> RunConfig:
    return RunConfig(attn_impl="plain", q_chunk=64, kv_chunk=64,
                     seq_chunk=16, grad_accum=grad_accum,
                     grad_compress=compress, use_zero1=zero1,
                     data_axes=("data",))


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
    ap.add_argument("--eager", action="store_true",
                    help="step eagerly where the step would be captured")
    return ap


class Trainer:
    """One model, its optimizer state and data stream: on one device, or,
    with ``mesh``, this rank's part of a run over it (the batch split over
    the data axis, the parameters this rank's shards of a model axis above
    one, the moments sharded over data under ``RunConfig.use_zero1``). What ``main`` drives, and what a caller that
    wants the step itself (and its timings) drives directly.

    ``compiled``: None runs the step as ``eager_reason`` rules (captured
    on one CUDA rank, eager elsewhere), True asks for the
    ``TrainExecutable`` and raises where the rule says no (on the CPU it
    runs its body eagerly on its static tensors), False steps eagerly.
    ``self.compiled`` says which runs."""

    def __init__(self, cfg, run: RunConfig, *, seq: int, batch: int,
                 lr: float, seed: int = 0, device=None,
                 mesh: Optional[S.Mesh] = None,
                 compiled: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cfg, self.seq, self.batch, self.mesh = cfg, seq, batch, mesh
        with S.use_mesh(mesh):
            self.model = build_model(cfg, run, device=self.device)
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed))
        self.params = trainable(self.model)
        self.pspecs = optimizer_pspecs(self.model)
        self.opt = adamw_init(self.params, self.model.param_pspecs(),
                              self.pspecs.mu, mesh)
        self.step_fn = make_train_step(self.model, lr=lr, mesh=mesh)
        self.eager_reason = eager_reason(cfg, run, mesh)
        if compiled is None:
            compiled = self.eager_reason is None \
                and self.device.type == "cuda"
        elif compiled and self.eager_reason is not None:
            raise ValueError(f"{cfg.name}: the train step cannot be "
                             f"captured: {self.eager_reason}")
        self.exe = None
        if compiled:
            shape = torch.empty((batch, seq), dtype=torch.int32,
                                device="meta")
            self.exe = TrainExecutable(
                self.step_fn, self.opt, {"tokens": shape, "labels": shape},
                self.device, who=cfg.name)
        self.stream = ZipfLMStream(vocab=cfg.vocab, seq=seq, batch=batch,
                                   seed=seed + 1, device=self.device)

    @property
    def compiled(self) -> bool:
        """Whether the steps run through the ``TrainExecutable``."""
        return self.exe is not None

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    def shardings(self):
        """The state's layout on the mesh (None on one device)."""
        if self.mesh is None:
            return None
        return named_shardings({"params": self.model.param_pspecs(),
                                "opt": self.pspecs}, self.mesh)

    def moment_bytes(self) -> int:
        """Bytes of optimizer moments this rank holds."""
        return sum(t.numel() * t.element_size()
                   for tree in (self.opt.mu, self.opt.nu)
                   for t in tree.values())

    def save(self, ckpt_dir: str, step: int, async_save: bool = False):
        return save_checkpoint(ckpt_dir, step, self.state(),
                               async_save=async_save,
                               shardings=self.shardings())

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Load a checkpoint into the live parameters and optimizer state;
        returns its step."""
        state, at = restore_checkpoint(ckpt_dir, step, self.state(),
                                       shardings=self.shardings())
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
            if self.exe is None:
                self.opt = state["opt"]
                return at
            # the executable's graph reads and writes its own tensors
            for mine, theirs in ((self.opt.mu, state["opt"].mu),
                                 (self.opt.nu, state["opt"].nu)):
                for k, t in mine.items():
                    t.copy_(theirs[k])
            self.opt.step.copy_(state["opt"].step)
        return at

    def step(self, i: int) -> dict:
        """Train step ``i`` on batch ``i`` of the stream, the codec's noise
        from a generator seeded with ``i``. The metrics are 0-d device
        tensors of this step (copies of the executable's)."""
        batch = self.stream.batch_at(i)
        if self.exe is not None:
            return {k: v.clone() for k, v in self.exe(batch).items()}
        g = torch.Generator(device=self.device).manual_seed(i)
        self.opt, m = self.step_fn(self.opt, batch, g)
        return m


@contextlib.contextmanager
def process_group():
    """The default process group: ``torchrun``'s (``env://``) when its
    environment is set, else a group of this one process; torn down on the
    way out if this made it. A group the caller made is used as it is."""
    if dist.is_initialized():
        yield
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, d_ff=384,
                          vocab=2048)
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        device = resolve_device(None)
    with process_group():
        mesh = make_local_mesh(device_type=device.type)
        return _train(args, cfg, mesh, device)


def _train(args, cfg, mesh, device) -> dict:
    tr = Trainer(cfg, run_config(args.grad_accum, args.compress, args.zero1),
                 seq=args.seq, batch=args.batch, lr=args.lr, seed=args.seed,
                 device=device, mesh=mesh,
                 compiled=False if args.eager else None)
    lead = dist.get_rank() == 0
    n = sum(p.numel() for p in tr.params.values())
    if lead:
        print(f"[train] {cfg.name}: {n/1e6:.1f}M params on {tr.device}, "
              f"mesh {mesh.shape}, compiled {tr.compiled}")

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start = tr.restore(args.ckpt_dir)
        if lead:
            print(f"[train] resumed from step {start}")

    # each step's loss stays on the device until a read every 20 steps and
    # at the end, the reference's cadence
    losses, pending, writer = [], [], None
    t0 = time.time()
    for i in range(start, start + args.steps):
        m = tr.step(i)
        pending.append(m["loss"])
        if (i + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = tr.save(args.ckpt_dir, i + 1, async_save=True)
        if (i + 1) % 20 == 0:
            losses += torch.stack(pending).tolist()
            pending = []
            sync(tr.device)
            tps = args.batch * args.seq * 20 / (time.time() - t0)
            t0 = time.time()
            if lead:
                print(f"[train] step {i+1:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(m['grad_norm']):.2f} {tps:,.0f} tok/s")
    if pending:
        losses += torch.stack(pending).tolist()
    if writer is not None:
        writer.join()
    end = start + args.steps
    if end % args.ckpt_every:          # else the last async save holds it
        tr.save(args.ckpt_dir, end)
    dist.barrier()                     # every rank sees the files written
    if lead:
        print(f"[train] done at step {end}")
    return {"start": start, "end": end, "losses": losses, "trainer": tr}


if __name__ == "__main__":
    main()
