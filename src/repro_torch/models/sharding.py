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
    global tensor and the way back; ``shard_param`` and ``keep_local`` — a
    model's parameters on a mesh (allocated at their shard; the shard kept
    of the single-device draw); ``local_zeros`` a zeroed cache at its shard;
  * ``vocab_lookup``, ``vocab_logits`` — an embedding and a head split over
    the vocabulary (a masked lookup and ``psum``; the local columns,
    gathered), as every family with such specs computes them;
  * ``psum``, ``copy_to``, ``all_gather``, ``all_gather_rs``, ``pmax`` —
    over one mesh axis or a tuple of axes. **Every collective of the port
    goes through these.** Axes that are missing from the mesh or of size 1
    are dropped, and with none left the call is the identity (no
    communication). The first four carry a gradient, and their names say
    which backward a call site gets (Megatron's, written for GSPMD's
    derivative of the global program):

      - ``psum``: a row-parallel output used replicated; backward identity
        (``psum_matmul`` is the row-parallel product and its ``psum``, the
        partials in fp32);
      - ``copy_to``: a replicated value entering per-rank compute (a
        column-parallel input, or a replicated weight per-rank compute
        reads); forward identity, backward ``psum``;
      - ``all_gather``: a gather used replicated (the logits); backward
        this rank's slice;
      - ``all_gather_rs``: a gather each rank uses differently (Zamba2's
        projection, FSDP experts); backward a reduce-scatter;
      - ``pmax`` carries none (the distributed flash-decode serves only).

A dimension that the spec's axes do not divide raises ``ValueError`` naming
the leaf. That is what the reference does at the same place: ``jax.jit``
with an ``in_shardings`` of ``P("model")`` on a (6, 2) array over four
devices raises ``ValueError`` ("... implies that the global size of its
dimension 0 should be divisible by 4"), as does ``jax.device_put`` (checked
with JAX 0.9 on four fake CPU devices). A ``Padded`` spec entry
instead splits its dimension by whole blocks (a head's columns, a
vocabulary row) and zero-pads it to the next multiple of the shards, as
GSPMD pads the heads it partitions itself: every rank then holds the same
number of blocks, the trailing ranks some or all of them zeros
(``local_shape``, ``local_shard``, ``shard_param``, ``keep_local``), and
``gather`` drops the padding. A padded entry is the axis name to every
comparison, so a spec with one equals the reference's.

Every collective notes its kind (the HLO's name: ``all-reduce``,
``all-gather``), the bytes of its result buffer and its group size into
the active ``CollectiveLog`` (``log_collectives``; none by default, and
then nothing is noted): the port's counterpart of parsing the optimized
HLO for its collectives (``launch/collectives.py``).

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


class Padded(str):
    """A spec entry over one mesh axis that splits a dimension of ``size``
    by whole blocks of ``unit`` (query heads: ``unit`` the head dim) and
    pads it with zero blocks to a multiple of the axis's ranks. It is the
    axis name to ``==``, ``hash`` and the mesh, so a spec holding one
    equals the reference's."""

    def __new__(cls, axis: str, size: int, unit: int = 1):
        if size % unit:
            raise ValueError(f"{size} is not a whole number of {unit}-wide "
                             "blocks")
        obj = super().__new__(cls, axis)
        obj.size, obj.unit = int(size), int(unit)
        return obj


def blocks_per_rank(n_blocks: int, axes, mesh: Optional["Mesh"] = None
                    ) -> Tuple[int, int, int]:
    """``(per, first, real)``: the blocks each rank of ``axes`` holds once
    ``n_blocks`` are padded to a multiple of the ranks, this rank's first
    block, and how many of its blocks are real (not padding)."""
    mesh = _mesh(mesh)
    n = 1 if mesh is None else mesh.size(axes)
    per = -(-n_blocks // n)
    first = (0 if mesh is None else mesh.index(axes)) * per
    return per, first, max(0, min(per, n_blocks - first))


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

def _layout(shape: Sequence[int], spec: P, mesh: Optional[Mesh],
            name: str) -> Tuple[Tuple[slice, ...], Tuple[int, ...]]:
    """This rank's slice of the global ``shape`` (its real part) and the
    shape it holds (the slice plus any zero padding at the end)."""
    mesh = _mesh(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than its "
                         f"shape {tuple(shape)}")
    real, held = [], []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = 1 if mesh is None else mesh.size(entry)
        j = 0 if mesh is None else mesh.index(entry)
        if isinstance(entry, Padded):
            if n != entry.size:
                raise ValueError(f"{name}: dimension {i} of {tuple(shape)} "
                                 f"is not the {entry.size} its spec pads")
            step = -(-n // entry.unit // k) * entry.unit
        elif n % k:
            raise ValueError(
                f"{name}: dimension {i} of {tuple(shape)} is not divisible "
                f"by the {k} shards of {entry!r} (spec {spec})")
        else:
            step = n // k
        real.append(slice(min(j * step, n), min((j + 1) * step, n)))
        held.append(step)
    return tuple(real), tuple(held)


def local_slices(shape: Sequence[int], spec: P, mesh: Optional[Mesh] = None,
                 name: str = "tensor") -> Tuple[slice, ...]:
    """This rank's slice of a global ``shape`` laid out by ``spec``: its
    real part, without the padding of a ``Padded`` entry."""
    return _layout(shape, spec, mesh, name)[0]


def local_shape(shape: Sequence[int], spec: P, mesh: Optional[Mesh] = None,
                name: str = "tensor") -> Tuple[int, ...]:
    """The shape this rank holds of a global ``shape``, padding included."""
    return _layout(shape, spec, mesh, name)[1]


def padded_to(part: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``part`` zero-padded at the end of each dimension to ``shape`` (the
    rank's real part -> what it holds); ``part`` itself when it fills it."""
    if tuple(part.shape) == tuple(shape):
        return part
    out = torch.zeros(shape, dtype=part.dtype, device=part.device)
    out[tuple(slice(0, n) for n in part.shape)] = part
    return out


def local_shard(full: torch.Tensor, spec: P, mesh: Optional[Mesh] = None,
                name: str = "tensor") -> torch.Tensor:
    """This rank's shard of the global tensor ``full``: a view, or a
    zero-padded copy where a ``Padded`` entry pads it."""
    real, held = _layout(full.shape, spec, mesh, name)
    return padded_to(full[real], held)


def shard_param(shape: Sequence[int], dtype: torch.dtype, spec: P,
                mesh: Optional[Mesh], name: str,
                device) -> torch.nn.Parameter:
    """An uninitialised parameter of global ``shape``: this rank's shard of
    it on ``mesh`` (the whole with none), made without gradients (a
    trainer turns them on). Padding, where a ``Padded`` entry adds some, is
    zeros."""
    make = torch.empty
    if mesh is not None:
        real, shape = _layout(shape, spec, mesh, name)
        if tuple(s.stop - s.start for s in real) != shape:
            make = torch.zeros
    return torch.nn.Parameter(make(shape, dtype=dtype, device=device),
                              requires_grad=False)


def keep_local(full: torch.Tensor, spec: P, mesh: Optional[Mesh],
               name: str = "tensor") -> torch.Tensor:
    """``full`` itself with no mesh, else this rank's shard of it (how a
    model on a mesh keeps its slice of the single-device draw)."""
    return full if mesh is None else local_shard(full, spec, mesh, name)


def local_zeros(shapes: Dict[str, Tuple[tuple, torch.dtype]],
                specs: Optional[Dict[str, P]], mesh: Optional[Mesh],
                device) -> Dict[str, torch.Tensor]:
    """Zeroed tensors at global ``shapes`` (name -> (dims, dtype)): this
    rank's part of ``specs`` on a mesh, the whole with no mesh."""
    if mesh is not None:
        shapes = {k: (local_shape(d, specs[k], mesh, k), dt)
                  for k, (d, dt) in shapes.items()}
    return {k: torch.zeros(d, dtype=dt, device=device)
            for k, (d, dt) in shapes.items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], pspecs: Dict[str, P],
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` -> this rank's shards, by ``pspecs`` (what
    ``load_state_dict`` of a model built on the mesh takes)."""
    return {k: local_shard(v, pspecs[k], mesh, k).contiguous()
            for k, v in sd.items()}


def gather(local: torch.Tensor, spec: P,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global tensor from every rank's ``local`` shard (collective),
    the padding of ``Padded`` entries dropped."""
    for dim, entry in enumerate(spec):
        local = all_gather(local, entry, dim, mesh)
        if isinstance(entry, Padded):
            local = local.narrow(dim, 0, entry.size)
    return local


# -- collectives ------------------------------------------------------------------
#
# Each carries a gradient, and its backward depends on what its output
# feeds (Megatron's f / g pair and its gathers). Where no gradient is
# tracked (no grad mode, or an input that does not require grad) the call is
# the plain collective and nothing else runs.

def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class CollectiveLog:
    """The collectives run while it is active (``log_collectives``):
    ``records`` holds one ``{"kind", "bytes", "group"}`` each, ``bytes``
    the result buffer's (a sum's fp32 buffer, a gather's whole output).
    ``run`` makes every collective of the port: a subclass may time it."""

    def __init__(self):
        self.records = []

    def run(self, kind: str, nbytes: int, group_size: int, call):
        self.records.append({"kind": kind, "bytes": int(nbytes),
                             "group": int(group_size)})
        return call()


_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collective_log", default=None)


@contextlib.contextmanager
def log_collectives(log: CollectiveLog):
    """Note every collective into ``log`` inside the block."""
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def get_log() -> Optional[CollectiveLog]:
    """The active collective log, or None."""
    return _LOG.get()


def _collective(kind: str, out: torch.Tensor, n_out: int, g, call,
                log: Optional[CollectiveLog] = None) -> None:
    """Run ``call()``, a collective over group ``g`` whose result buffer is
    ``n_out`` tensors like ``out``, noted into ``log``, by default the
    active one, if any."""
    log = log if log is not None else _LOG.get()
    if log is None:
        call()
    else:
        log.run(kind, n_out * out.numel() * out.element_size(),
                dist.get_world_size(g), call)


def _sum(x: torch.Tensor, g, log: Optional[CollectiveLog] = None
         ) -> torch.Tensor:
    y = x.float() if x.dtype != torch.float32 else x.clone()
    _collective("all-reduce", y, 1, g,
                lambda: dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g),
                log)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, g, n: int, dim: int) -> torch.Tensor:
    src = x.contiguous()
    # a gather copies bytes: bf16 travels as fp16 words, which every gloo
    # build takes (no arithmetic touches them on the way)
    raw = src.view(torch.float16) if src.dtype == torch.bfloat16 else src
    parts = [torch.empty_like(raw) for _ in range(n)]
    _collective("all-gather", raw, n, g,
                lambda: dist.all_gather(parts, raw, group=g))
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bfloat16) if src.dtype == torch.bfloat16 else out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _sum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


# autograd runs a CUDA backward on a thread of its own, where the log's
# context variable is unset: a backward notes into the log its forward saw

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.log = g, _LOG.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.g, ctx.log), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n, i, dim, reduce_grad):
        ctx.g, ctx.i, ctx.dim, ctx.size = g, i, dim, x.shape[dim]
        ctx.reduce_grad, ctx.log = reduce_grad, _LOG.get()
        return _gather(x, g, n, dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.reduce_grad:
            dy = _sum(dy, ctx.g, ctx.log)
        return (dy.narrow(ctx.dim, ctx.i * ctx.size, ctx.size).contiguous(),
                None, None, None, None, None)


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over the ranks of ``axes``, in fp32, returned in ``x``'s dtype,
    for a result used **replicated** (a row-parallel output feeding the
    residual stream; Megatron's *g*): every rank then holds the whole
    gradient of the sum, which is each addend's, so the backward is the
    identity."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    return _Psum.apply(x, g) if _tracked(x) else _sum(x, g)


def psum_matmul(a: torch.Tensor, b: torch.Tensor, axes,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The row-parallel product ``a @ b`` (``b`` this rank's rows, ``a``
    its columns) summed over ``axes`` (``psum``), in ``a``'s dtype. A
    rank's partial is the GEMM's fp32 accumulator, taken before it is
    rounded, so a bf16 result is rounded once, after the sum, as one device
    rounds the whole product; rounding each partial first, as a bf16
    product's reduction over shards does, puts 2^-9 of every partial into
    the sum. On the card a 16-bit product stays a 16-bit GEMM with an fp32
    output (``torch.mm(..., out_dtype=float32)``: no fp32 copy of the
    weight); elsewhere, or where autograd records it, the operands widen
    (exactly). The plain product when ``axes`` span one rank."""
    mesh = _mesh(mesh)
    if mesh is None or mesh.group(axes) is None:
        return torch.matmul(a, b)
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype and b.dim() == 2 \
            and not _tracked(a) and not _tracked(b):
        part = torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32)
        part = part.reshape(*a.shape[:-1], b.shape[-1])
    else:
        part = torch.matmul(a.float(), b.float())
    return psum(part, axes, mesh).to(a.dtype)


def copy_to(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """A replicated value entering per-rank compute (the input of a
    column-parallel matmul, a replicated weight that per-rank compute
    reads; Megatron's *f*): the identity forward, no communication; the
    backward sums the ranks' partial gradients over ``axes``."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None or not _tracked(x):
        return x
    return _CopyTo.apply(x, g)


def pmax(x: torch.Tensor, axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axes``. Gradient-free: its
    one user, the distributed flash-decode, serves only."""
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    y = x.detach().clone()
    _collective("all-reduce", y, 1, g,
                lambda: dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g))
    return y


def _all_gather(x, axes, dim, mesh, reduce_grad):
    mesh = _mesh(mesh)
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return x
    n, dim = mesh.size(axes), dim % x.ndim
    if _tracked(x):
        return _AllGather.apply(x, g, n, mesh.index(axes), dim, reduce_grad)
    return _gather(x, g, n, dim)


def all_gather(x: torch.Tensor, axes, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ranks' ``x`` of ``axes`` concatenated along ``dim`` in their
    row-major order over the axes (the reference's tiled ``all_gather``),
    for a result used **replicated** (the logits): every rank holds the
    same whole gradient, so the backward is this rank's slice of it."""
    return _all_gather(x, axes, dim, mesh, reduce_grad=False)


def all_gather_rs(x: torch.Tensor, axes, dim: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``all_gather`` for a result that each rank uses **differently**
    (Zamba2's projection, of which a rank keeps its own heads; FSDP
    experts, each data rank on its own rows): the ranks' gradients of the
    whole differ, so the backward is a reduce-scatter: their sum over
    ``axes`` (in fp32), sliced to this rank's part."""
    return _all_gather(x, axes, dim, mesh, reduce_grad=True)


# -- the vocabulary split ------------------------------------------------------------

def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, axes,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Rows ``tokens`` of an embedding ``table`` whose rows (the
    vocabulary) are split over ``axes``: a masked local lookup, then
    ``psum``, which hands each rank its rows' gradient. The plain lookup
    when ``axes`` span one rank."""
    mesh = _mesh(mesh)
    if mesh is None or mesh.group(axes) is None:
        return table[tokens.long()]
    rows = table.shape[0]
    t = tokens.long() - mesh.index(axes) * rows
    hit = (t >= 0) & (t < rows)
    return psum(table[t.clamp(0, rows - 1)] * hit[..., None], axes, mesh)


def vocab_logits(x: torch.Tensor, head: torch.Tensor, axes,
                 mesh: Optional[Mesh] = None,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """``x @ head`` for a replicated ``x`` and a ``head`` whose columns
    (the vocabulary) are split over ``axes``: the local columns, gathered
    (every rank returns the whole), cut to ``vocab`` columns where the
    split padded them (so no softmax, argmax or loss sees the padding)."""
    out = all_gather(torch.matmul(copy_to(x, axes, mesh), head), axes, -1,
                     mesh)
    if vocab is not None and out.shape[-1] != vocab:
        out = out[..., :vocab]
    return out
