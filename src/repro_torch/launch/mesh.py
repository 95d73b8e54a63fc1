"""Mesh definitions over the process group's world.

Counterpart of ``repro.launch.mesh``. Functions, so that importing this
module touches no process group. The reference's topology: TPU v5e pods of
256 chips arranged (16, 16) = (data, model); multi-pod adds a leading DCN
"pod" axis, (2, 16, 16) = (pod, data, model). Batch shards over (pod, data),
tensor and expert parallelism over model.

Here a mesh's ranks are the processes of the default group
(``torch.distributed``), which the caller initialised: ``torchrun`` (the
``env://`` rendezvous), or processes spawned with a ``file://`` or
``tcp://localhost:<port>`` address. On one H100 the ranks are processes
sharing ``cuda:0`` over gloo (``models/sharding.py`` says why).
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from repro_torch.models.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(n_model: int = 1, device_type: str = "cuda") -> Mesh:
    """A (world // n_model, n_model) = (data, model) mesh over every rank
    of the default group (tests, examples, the train launcher)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: initialise the default process "
                           "group first (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    n_model = min(n_model, n)
    return make_mesh((n // n_model, n_model), ("data", "model"), device_type)


def mesh_axis_names(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def _rank_entry(rank: int, fn, world: int, rendezvous: str, args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        fn(rank, world, *args)
        dist.barrier()          # leave together: no rank tears down early
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, rendezvous: str,
              timeout: float) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` processes started with
    ``spawn`` and joined in one gloo group (a ``file://`` rendezvous at
    ``rendezvous``, a path that must not exist yet): the mesh of one host,
    or of one card shared by every rank. ``fn`` must be importable by the
    children (a module-level function). Raises when a rank fails (the
    others are stopped) or when ``timeout`` seconds pass; returns when
    every rank has ended well."""
    import torch.multiprocessing as mp
    if os.path.exists(rendezvous):
        raise FileExistsError(f"rendezvous file {rendezvous} exists")
    ctx = mp.start_processes(_rank_entry,
                             args=(fn, world, rendezvous, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
