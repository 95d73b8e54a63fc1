"""Public kernel entry points with implementation dispatch.

``impl``:
  * "kernel"    — the hand-written CUDA kernel on CUDA tensors (no
                  fall-back: it launches or raises); the plain version on
                  CPU tensors, which is how the CPU tests reach it;
  * "plain"     — the plain PyTorch version on whatever device the tensors
                  are on (the kernels' on-device yardstick);
  * "reference" — the O(S^2) oracles of ``ref.py`` (tests only).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain

_decode_kernel = _k1.decode_attention
_flash_kernel = _k2.flash_attention


def flash_attention(q, k, v, causal=True, q_chunk=512, kv_chunk=1024,
                    q_offset=0, impl="kernel"):
    if impl == "kernel":
        return _flash_kernel(q, k, v, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, q_offset=q_offset)
    if impl == "plain":
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, q_offset=q_offset)
    if impl == "reference":
        from repro_torch.models.layers import repeat_kv
        g = q.shape[2] // k.shape[2]
        return ref.flash_attention_ref(q, repeat_kv(k, g), repeat_kv(v, g),
                                       causal=causal, q_offset=q_offset)
    raise ValueError(impl)


def decode_attention(q, k_cache, v_cache, cache_len, impl="kernel"):
    if impl == "kernel":
        return _decode_kernel(q, k_cache, v_cache, cache_len)
    if impl == "plain":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if impl == "reference":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    raise ValueError(impl)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {"decode_attention": _decode_kernel.launches,
            "flash_attention": _flash_kernel.launches}


def reset_launch_counts() -> None:
    _decode_kernel.launches = 0
    _flash_kernel.launches = 0
