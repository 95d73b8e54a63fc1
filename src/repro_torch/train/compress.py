"""int8 gradient compression with stochastic rounding.

Counterpart of ``repro.train.compress``: per-tensor absmax scaling to
[-127, 127] and stochastic rounding, which keeps the quantizer unbiased
(E[deq(q(x))] = x) and so usable on the gradient path before the
optimizer. The noise comes from ``torch.Generator``s, never from the global
generator. The reference folds a leaf's index into one key
(``fold_in(key, i)``); here one seed is drawn from the caller's generator
and each leaf gets a generator of its own, seeded from that seed and the
leaf's index (``leaf_seed``). The two give different bits from the same
seed, so tests hold this codec to the reference by its properties.

Trees are dicts of tensors, taken in sorted key order (the reference's
``jax.tree.flatten`` order).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_MASK64 = (1 << 64) - 1


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of a tree compressed under
    ``seed``: splitmix64 of the pair, so neighbouring leaves and
    neighbouring seeds get unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, fp32 0-d scale). ``generator`` lives on x's
    device."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    y = xf / scale
    lo = torch.floor(y)
    up = torch.rand(x.shape, generator=generator, device=x.device) < y - lo
    q = torch.clamp(lo + up.float(), -128, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _leaf_generators(tree: Dict[str, torch.Tensor],
                     generator: torch.Generator):
    """(key, leaf, its generator) in sorted key order. The one seed drawn
    from ``generator`` advances it, so a generator reused across steps
    gives each step new noise."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    for i, k in enumerate(sorted(tree)):
        leaf = tree[k]
        g = torch.Generator(device=leaf.device).manual_seed(leaf_seed(seed, i))
        yield k, leaf, g


def compress_tree(tree: Dict[str, torch.Tensor], generator: torch.Generator
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    return {k: quantize_int8(leaf, g)
            for k, leaf, g in _leaf_generators(tree, generator)}


def decompress_tree(ctree: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    return {k: dequantize_int8(q, s, dtype) for k, (q, s) in ctree.items()}


def roundtrip_tree(tree: Dict[str, torch.Tensor], generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    """Quantize and dequantize every leaf, back in its own dtype: the
    numerical effect of a compressed all-reduce."""
    return {k: dequantize_int8(*quantize_int8(leaf, g), leaf.dtype)
            for k, leaf, g in _leaf_generators(tree, generator)}
