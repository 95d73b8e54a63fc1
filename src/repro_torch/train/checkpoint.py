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

``restore_checkpoint(..., device=...)`` is the single-device counterpart
of the reference's ``shardings``: every leaf lands on ``device``, or, when
it is None, on the device of its counterpart in ``like``. Restoring onto
another mesh (elastic resharding) waits for the sharded path (ROADMAP A13).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.compat import DeviceLike
from repro_torch.train import msgpack_codec

_CHUNK_BYTES = 256 * 1024 * 1024
_BF16_HEADER = {"descr": "<V2", "fortran_order": False}


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
                    async_save: bool = False) -> Optional[threading.Thread]:
    """Save a tree of tensors. The copy to the host happens here; with
    ``async_save`` the files are written by a thread, which is returned."""
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    host = []
    manifest = {"step": step, "leaves": []}
    for lpath, leaf in _leaf_paths(tree):
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

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(ckpt_dir: str, rec: dict) -> torch.Tensor:
    safe = rec["path"].strip("/").replace("/", ".")
    if rec["chunks"] == 1:
        arr = np.load(os.path.join(ckpt_dir, f"{safe}.npy"))
    else:
        arr = np.concatenate(
            [np.load(os.path.join(ckpt_dir, f"{safe}.{ci:04d}.npy"))
             for ci in range(rec["chunks"])], axis=0)
    arr = arr.reshape(rec["shape"])
    if rec["dtype"] != "bfloat16":
        return torch.from_numpy(np.array(arr, dtype=rec["dtype"], order="C"))
    if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
        raise ValueError(f"{rec['path']}: bfloat16 stored as {arr.dtype}, "
                         "not as its two raw bytes")
    return torch.from_numpy(
        np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)


def restore_checkpoint(path: str, step: Optional[int], like: Any,
                       device: DeviceLike = None):
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything in the leaves' places); returns ``(tree, step)``. Only the
    leaves ``like`` names are read."""
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
        return _load_leaf(ckpt_dir, records[prefix]).to(dev)

    return rebuild(like), manifest["step"]
