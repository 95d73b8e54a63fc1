"""Parameter conversion between the reference's tree and the port's modules.

The reference side is handed over **as numpy**: a nested dict of numpy
arrays with the reference's keys (``embed``, ``final_norm``, ``layers`` →
``{ln1, wq, ...}``, optional ``lm_head``; Whisper's ``encoder`` and
``decoder`` subtrees, Zamba2's ``mamba`` and ``shared``), bf16 leaves
travelling as float32. Nesting maps onto dotted ``state_dict`` names
(``decoder.x_wq``) both ways. The caller does the framework → numpy step, so nothing here
imports anything but numpy and torch.
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


def to_state_dict(tree: Mapping, like: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """numpy tree -> tensors with the dtype and device of ``like`` (a
    module's ``state_dict()``); keys and shapes must match exactly."""
    flat = flatten_tree(tree)
    if set(flat) != set(like):
        raise KeyError(f"parameter keys differ: only in tree "
                       f"{sorted(set(flat) - set(like))}, only in module "
                       f"{sorted(set(like) - set(flat))}")
    out = {}
    for name, ref in like.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=ref.device, dtype=ref.dtype)
    return out


def load_params(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a numpy parameter tree into ``module`` in place."""
    module.load_state_dict(to_state_dict(tree, module.state_dict()))
    return module


def to_numpy_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The way back: a module's ``state_dict()`` -> nested dict of float32
    numpy arrays (bf16 widens exactly)."""
    return unflatten_tree({
        name: t.detach().to(device="cpu", dtype=torch.float32).numpy()
        for name, t in state_dict.items()})
