"""Mesh helpers: partition specs, the active mesh, shards and collectives.

Counterpart of ``repro.models.sharding``. The reference lays every array
out by a ``PartitionSpec`` and lets GSPMD partition the plain model code;
eager PyTorch has no such partitioner, so here a rank holds its *local
shard* of every sharded tensor and the models call the collectives
themselves (tensor-parallel arithmetic written out, as GSPMD derives it).
What the reference spreads over ``jax.make_mesh``, ``use_mesh``,
``get_abstract_mesh`` and ``with_sharding_constraint``:

  * ``P`` — a PartitionSpec twin: a tuple whose entries are ``None``, an
    axis name or a tuple of axis names. It equals the reference's spec
    converted to a tuple;
  * ``make_mesh(axis_shapes, axis_names, device_type="cuda")`` — a
    ``Mesh`` over ``torch.distributed.device_mesh.init_device_mesh`` on the
    default process group, which the caller initialised (``torchrun``'s
    ``env://``, or a ``file://``/``tcp://localhost`` rendezvous of spawned
    processes). Besides the device mesh's one group per axis it makes one
    group per combination of axes, so ``("pod", "data")`` reduces in one
    collective;
  * ``use_mesh(mesh)`` — a context manager making ``mesh`` the active one
    (a context variable; ``get_mesh()`` reads it, ``None`` outside);
  * ``mesh_axis_sizes``, ``filter_spec``, ``constrain`` — as the
    reference's, over the active mesh;
  * ``local_shape``, ``local_shard``, ``gather`` — a rank's slice of a
    global tensor and the way back;
  * ``psum``, ``pmax``, ``all_gather`` — over one mesh axis or a tuple of
    axes. **Every collective of the port goes through these.** Axes that
    are missing from the mesh or of size 1 are dropped, and with none left
    the call is the identity (no communication).

A dimension that the spec's axes do not divide raises ``ValueError`` naming
the leaf. That is what the reference does at the same place: ``jax.jit``
with an ``in_shardings`` of ``P("model")`` on a (6, 2) array over four
devices raises ``ValueError`` ("... implies that the global size of its
dimension 0 should be divisible by 4"), as does ``jax.device_put`` (checked
with JAX 0.9 on four fake CPU devices). GSPMD pads only intermediate values
it partitions itself; padding here waits for a later slice (ROADMAP A13c).

The collectives run over whatever backend the default group has. On one
H100 a mesh of N ranks is N processes on ``cuda:0``, where NCCL refuses two
ranks on one device, so the card runs the mesh over gloo, which stages CUDA
tensors through host memory; a sum is taken in fp32 whatever the input's
dtype (gloo's own bf16 sum rounds at every step), and a gather moves a bf16
tensor's raw 16-bit words as fp16 (gloo has no int16).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _entry(e):
    """An entry as the reference's ``PartitionSpec`` keeps it: a list is a
    tuple, a tuple of one name is the name, an empty one is None."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """PartitionSpec twin: ``P("data", None)``, ``P(("pod", "data"), None,
    "model")``, normalised as the reference normalises its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None`` -> ``()``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """A ``DeviceMesh`` with what the port reads of it: axis names and
    sizes, this rank's coordinate on each axis, and a process group for
    every combination of axes."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 axis_sizes: Sequence[int], device_type: str):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        self.device_type = device_type
        self.coord = dict(zip(self.axis_names,
                              device_mesh.get_coordinate()))
        self._groups: Dict[Tuple[str, ...], object] = {}
        ranks = device_mesh.mesh
        for r in range(2, len(self.axis_names) + 1):
            for dims in itertools.combinations(range(len(self.axis_names)),
                                               r):
                # every rank makes every group (new_group is collective),
                # keeping the one it is in; rows are in combined-axis order
                rest = [i for i in range(ranks.ndim) if i not in dims]
                rows = ranks.permute(*rest, *dims).reshape(
                    -1, math.prod(self.axis_sizes[i] for i in dims))
                for row in rows.tolist():
                    g = dist.new_group(ranks=row)
                    if dist.get_rank() in row:
                        self._groups[tuple(self.axis_names[i]
                                           for i in dims)] = g

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def live_axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) kept to those of
        this mesh with more than one rank, in mesh order."""
        want = set(entry_axes(axes))
        return tuple(a for a, n in zip(self.axis_names, self.axis_sizes)
                     if a in want and n > 1)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.live_axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (mesh order)."""
        idx = 0
        for a in self.live_axes(axes):
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def group(self, axes):
        """The process group over ``axes``; None when they span one rank."""
        live = self.live_axes(axes)
        if not live:
            return None
        if len(live) == 1:
            return self.device_mesh.get_group(live[0])
        return self._groups[live]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type!r})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` over the default
    process group, whose world must have exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group "
                           "first (torch.distributed.init_process_group)")
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} sizes for {len(axis_names)} "
                         "axis names")
    n = math.prod(axis_shapes)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(axis_shapes)} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (device_type='cpu' "
                           "makes a mesh on the host)")
    dm = init_device_mesh(device_type, tuple(axis_shapes),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dm, axis_names, axis_shapes, device_type)


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh() -> Optional[Mesh]:
    """The active mesh, or None."""
    return _MESH.get()


def _mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return mesh if mesh is not None else _MESH.get()


def mesh_axis_sizes(mesh: Optional[Mesh] = None) -> dict:
    mesh = _mesh(mesh)
    return {} if mesh is None else mesh.shape


def filter_spec(spec: P, mesh: Optional[Mesh] = None) -> Optional[P]:
    """Drop axes that aren't in the current mesh; None if no mesh at all."""
    sizes = mesh_axis_sizes(mesh)
    if not sizes:
        return None
    dims = []
    for entry in spec:
        if entry is None:
            dims.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in sizes)
            dims.append(kept if kept else None)
        else:
            dims.append(entry if entry in sizes else None)
    return P(*dims)


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's layout hint (``with_sharding_constraint``). Eager
    code has nothing to constrain: a rank's tensor already is its shard,
    laid out by the code that made it, so this returns ``x``. With a mesh
    it checks what a rank can see: that ``spec`` names no more dimensions
    than ``x`` has, which the reference rejects too."""
    if get_mesh() is not None and len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{x.ndim}-d tensor")
    return x


# -- shards ----------------------------------------------------------------------

def local_slices(shape: Sequence[int], spec: P, mesh: Optional[Mesh] = None,
                 name: str = "tensor") -> Tuple[slice, ...]:
    """This rank's slice of a global ``shape`` laid out by ``spec``."""
    mesh = _mesh(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than its "
                         f"shape {tuple(shape)}")
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = 1 if mesh is None else mesh.size(entry)
        if n % k:
            raise ValueError(
                f"{name}: dimension {i} of {tuple(shape)} is not divisible "
                f"by the {k} shards of {entry!r} (spec {spec})")
        step = n // k
        j = 0 if mesh is None else mesh.index(entry)
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: P, mesh: Optional[Mesh] = None,
                name: str = "tensor") -> Tuple[int, ...]:
    return tuple(s.stop - s.start
                 for s in local_slices(shape, spec, mesh, name))


def local_shard(full: torch.Tensor, spec: P, mesh: Optional[Mesh] = None,
                name: str = "tensor") -> torch.Tensor:
    """This rank's shard of the global tensor ``full`` (a view)."""
    return full[local_slices(full.shape, spec, mesh, name)]


def shard_state_dict(sd: Dict[str, torch.Tensor], pspecs: Dict[str, P],
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` -> this rank's shards, by ``pspecs`` (what
    ``load_state_dict`` of a model built on the mesh takes)."""
    return {k: local_shard(v, pspecs[k], mesh, k).contiguous()
            for k, v in sd.items()}


def gather(local: torch.Tensor, spec: P,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global tensor from every rank's ``local`` shard (collective)."""
    for dim, entry in enumerate(spec):
        local = all_gather(local, entry, dim, mesh)
    return local


# -- collectives ------------------------------------------------------------------

def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over the ranks of ``axes``, in fp32, returned in ``x``'s dtype."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    y = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
    return y.to(x.dtype)


def pmax(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axes``."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
    return y


def all_gather(x: torch.Tensor, axes, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ranks' ``x`` of ``axes`` concatenated along ``dim`` in their
    row-major order over the axes (the reference's tiled ``all_gather``)."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    src = x.contiguous()
    # a gather copies bytes: bf16 travels as fp16 words, which every gloo
    # build takes (no arithmetic touches them on the way)
    raw = src.view(torch.float16) if src.dtype == torch.bfloat16 else src
    parts = [torch.empty_like(raw) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, raw, group=g)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bfloat16) if src.dtype == torch.bfloat16 else out
