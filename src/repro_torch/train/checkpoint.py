"""Checkpoints in the reference's layout, with async save.

Counterpart of ``repro.train.checkpoint``, file for file:
``<dir>/step_<N:08d>/manifest.msgpack`` (``{"step", "leaves": [{"path",
"shape", "dtype", "chunks"}]}``) plus one ``.npy`` per leaf, named by its
path with ``/`` turned into ``.``, split along dim 0 into
``<name>.<i:04d>.npy`` chunks above ``_CHUNK_BYTES``; the files go to
``step_<N>.tmp`` and the directory is renamed when all are written. So a
checkpoint the reference wrote restores here and one written here restores
there.

Trees are nested dicts, lists and tuples (``AdamWState`` is a NamedTuple,
as the reference's) of tensors. A dict keyed by ``state_dict`` names
(``"layers.wq"``) stands for the reference's nested dicts: its leaf's path
is ``/layers/wq``. bf16 leaves are written as the reference writes them,
two raw bytes an element under numpy's ``<V2`` descriptor with manifest
dtype ``bfloat16``, and read back bit for bit. (The reference's own
restore cannot read them: numpy has no cast from ``V2`` to ml_dtypes'
bfloat16, ROADMAP §C8.) The manifest goes through the port's own
MessagePack codec, byte-equal to ``msgpack.packb``.

``restore_checkpoint(..., device=...)`` puts every leaf on ``device``, or,
when it is None, on the device of its counterpart in ``like``.

On a mesh both take ``shardings``, a tree like the state's whose leaves are
``NamedSharding(mesh, P)`` (the reference's ``shardings=``). ``save``
gathers every leaf to its global shape (the reference's ``np.asarray``, a
collective: every rank calls it) and rank 0 writes, in the same layout, so
a checkpoint of a mesh restores on one device and in the reference.
``restore`` gives each rank only its slice of each leaf, read from the
``.npy`` files through a memory map, onto whatever mesh ``shardings``
names: the elastic restart onto another mesh shape.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.compat import DeviceLike
from repro_torch.models import sharding as S
from repro_torch.train import msgpack_codec

_CHUNK_BYTES = 256 * 1024 * 1024
_BF16_HEADER = {"descr": "<V2", "fortran_order": False}


class NamedSharding:
    """How one leaf lies on a mesh: ``(mesh, spec)``."""

    def __init__(self, mesh: S.Mesh, spec: S.P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


def named_shardings(specs: Any, mesh: S.Mesh) -> Any:
    """A tree of ``P`` (dicts, lists, tuples, NamedTuples) as a tree of
    ``NamedSharding`` on ``mesh``."""
    if isinstance(specs, S.P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named_shardings(v, mesh) for k, v in specs.items()}
    vals = [named_shardings(v, mesh) for v in specs]
    if hasattr(specs, "_fields"):
        return type(specs)(*vals)
    return vals if isinstance(specs, list) else tuple(vals)


def _nested(tree: dict) -> dict:
    """A dict with dotted keys as the nested dicts it stands for."""
    if not any("." in k for k in tree):
        return tree
    out: Dict = {}
    for k, v in tree.items():
        node = out
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _leaf_paths(tree, prefix=""):
    """(path, leaf) in the reference's order: dict keys sorted, sequences in
    index order."""
    if isinstance(tree, dict):
        nested = _nested(tree)
        for k in sorted(nested):
            yield from _leaf_paths(nested[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _to_host(leaf):
    """A leaf -> (numpy array, manifest dtype); bf16 as its raw bits. A
    copy, also of a CPU tensor: the caller may update the leaf in place
    while an async writer still holds it."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(
            fh, {**_BF16_HEADER, "shape": arr.shape})
        fh.write(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(path: str, step: int, tree: Any,
                    async_save: bool = False,
                    shardings: Any = None) -> Optional[threading.Thread]:
    """Save a tree of tensors. The copy to the host happens here; with
    ``async_save`` the files are written by a thread, which is returned.
    With ``shardings`` every rank must call it: the leaves are gathered,
    rank 0 writes, and a synchronous save ends on a barrier, so that every
    rank may read the checkpoint when it returns."""
    sharded = dict(_leaf_paths(shardings)) if shardings is not None else {}
    writer = not sharded or dist.get_rank() == 0
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    if writer:
        os.makedirs(tmp_dir, exist_ok=True)
    host = []
    manifest = {"step": step, "leaves": []}
    for lpath, leaf in _leaf_paths(tree):
        if lpath in sharded:
            sh = sharded[lpath]
            leaf = S.gather(leaf, sh.spec, sh.mesh)
        if not writer:
            continue
        arr, dtype = _to_host(leaf)
        n_chunks = 1
        if arr.ndim > 0:
            n_chunks = min(max(1, -(-arr.nbytes // _CHUNK_BYTES)),
                           arr.shape[0])
        manifest["leaves"].append({"path": lpath, "shape": list(arr.shape),
                                   "dtype": dtype, "chunks": n_chunks})
        host.append((lpath, arr, dtype == "bfloat16", n_chunks))

    def write():
        for lpath, arr, bf16, n_chunks in host:
            safe = lpath.strip("/").replace("/", ".")
            if n_chunks == 1:
                _save_npy(os.path.join(tmp_dir, f"{safe}.npy"), arr, bf16)
            else:
                for ci, chunk in enumerate(np.array_split(arr, n_chunks)):
                    _save_npy(os.path.join(tmp_dir, f"{safe}.{ci:04d}.npy"),
                              chunk, bf16)
        with open(os.path.join(tmp_dir, "manifest.msgpack"), "wb") as fh:
            fh.write(msgpack_codec.packb(manifest))
        os.replace(tmp_dir, ckpt_dir)   # publish

    if not writer:
        if not async_save:
            dist.barrier()
        return None
    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if sharded:
        dist.barrier()
    return None


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(ckpt_dir: str, rec: dict, index=None) -> torch.Tensor:
    """A leaf, or its part ``index`` (a tuple of slices): the files are
    memory-mapped, so only that part is read."""
    safe = rec["path"].strip("/").replace("/", ".")
    shape = tuple(rec["shape"])
    mmap = "r" if np.prod(shape) > 0 else None   # numpy maps no empty file
    if index is None:
        index = tuple(slice(0, n) for n in shape)
    if rec["chunks"] == 1:
        arr = np.load(os.path.join(ckpt_dir, f"{safe}.npy"), mmap_mode=mmap)
        arr = arr.reshape(shape)[index]
    else:
        # chunks split dim 0; keep each one's rows of the part
        parts, row = [], 0
        first, rest = index[0], index[1:]
        for ci in range(rec["chunks"]):
            c = np.load(os.path.join(ckpt_dir, f"{safe}.{ci:04d}.npy"),
                        mmap_mode=mmap)
            lo, hi = max(first.start, row), min(first.stop, row + len(c))
            if lo < hi:
                parts.append(c[(slice(lo - row, hi - row),) + rest])
            row += len(c)
        arr = np.concatenate(parts, axis=0)
    if rec["dtype"] != "bfloat16":
        return torch.from_numpy(np.array(arr, dtype=rec["dtype"], order="C"))
    if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
        raise ValueError(f"{rec['path']}: bfloat16 stored as {arr.dtype}, "
                         "not as its two raw bytes")
    return torch.from_numpy(
        np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)


def restore_checkpoint(path: str, step: Optional[int], like: Any,
                       device: DeviceLike = None, shardings: Any = None):
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything in the leaves' places); returns ``(tree, step)``. Only the
    leaves ``like`` names are read. ``shardings`` (a tree of
    ``NamedSharding`` beside ``like``'s leaves) gives each leaf it names as
    this rank's slice, from any mesh."""
    sharded = dict(_leaf_paths(shardings)) if shardings is not None else {}
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.msgpack"), "rb") as fh:
        manifest = msgpack_codec.unpackb(fh.read())
    records = {rec["path"]: rec for rec in manifest["leaves"]}

    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}/{k.replace('.', '/')}")
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            vals = [rebuild(v, f"{prefix}/{i}") for i, v in enumerate(t)]
            if hasattr(t, "_fields"):       # NamedTuple (AdamWState)
                return type(t)(*vals)
            return vals if isinstance(t, list) else tuple(vals)
        if prefix not in records:
            raise KeyError(f"{prefix}: not in the checkpoint of step {step}")
        dev = device if device is not None else (
            t.device if torch.is_tensor(t) else "cpu")
        rec = records[prefix]
        if prefix not in sharded:
            return _load_leaf(ckpt_dir, rec, None).to(dev)
        sh = sharded[prefix]
        index = S.local_slices(rec["shape"], sh.spec, sh.mesh, prefix)
        # the rank's slice, zero-padded where its spec pads the dimension
        return S.padded_to(_load_leaf(ckpt_dir, rec, index).to(dev),
                           S.local_shape(rec["shape"], sh.spec, sh.mesh,
                                         prefix))

    return rebuild(like), manifest["step"]
