"""Parameter conversion between the reference's tree and the port's modules.

The reference side is handed over **as numpy**: a nested dict of numpy
arrays with the reference's keys (``embed``, ``final_norm``, ``layers`` →
``{ln1, wq, ...}``, optional ``lm_head``; Whisper's ``encoder`` and
``decoder`` subtrees, Zamba2's ``mamba`` and ``shared``), bf16 leaves
travelling as float32. Nesting maps onto dotted ``state_dict`` names
(``decoder.x_wq``) both ways. The caller does the framework → numpy step, so nothing here
imports anything but numpy, torch and the port's own sharding helpers.

A model built on a mesh (inside ``sharding.use_mesh``) holds this rank's
shards: ``load_params`` then checks the tree against the model's global
``param_shapes()`` and loads each leaf's slice by ``param_pspecs()``, so
every family loads the reference's whole tree onto any mesh.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"layers.wq": array, ...}`` (state_dict naming)."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, name + "."))
        else:
            flat[name] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _checked(tree: Mapping, shapes: Mapping[str, tuple]
             ) -> Dict[str, np.ndarray]:
    """The flattened tree, its keys and shapes those of ``shapes``."""
    flat = flatten_tree(tree)
    if set(flat) != set(shapes):
        raise KeyError(f"parameter keys differ: only in tree "
                       f"{sorted(set(flat) - set(shapes))}, only in module "
                       f"{sorted(set(shapes) - set(flat))}")
    for name, shape in shapes.items():
        if tuple(flat[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {flat[name].shape} != "
                             f"{tuple(shape)}")
    return flat


def _tensor(arr, ref: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=ref.device, dtype=ref.dtype)


def to_state_dict(tree: Mapping, like: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """numpy tree -> tensors with the dtype and device of ``like`` (a
    module's ``state_dict()``); keys and shapes must match exactly."""
    flat = _checked(tree, {k: v.shape for k, v in like.items()})
    return {name: _tensor(flat[name], ref) for name, ref in like.items()}


def load_params(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a numpy parameter tree into ``module`` in place; on a mesh
    (``module.mesh``) each rank loads its shards of the global tree."""
    mesh = getattr(module, "mesh", None)
    if mesh is None:
        module.load_state_dict(to_state_dict(tree, module.state_dict()))
        return module
    from repro_torch.models import sharding as S
    specs = module.param_pspecs()
    flat = _checked(tree, {k: shape for k, (shape, _)
                           in module.param_shapes().items()})
    # the rank's slice, zero-padded where its spec pads the dimension
    module.load_state_dict({
        name: S.padded_to(_tensor(flat[name][S.local_slices(
            flat[name].shape, specs[name], mesh, name)], ref), ref.shape)
        for name, ref in module.state_dict().items()})
    return module


def to_numpy_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The way back: a module's ``state_dict()`` -> nested dict of float32
    numpy arrays (bf16 widens exactly)."""
    return unflatten_tree({
        name: t.detach().to(device="cpu", dtype=torch.float32).numpy()
        for name, t in state_dict.items()})
