"""Public kernel entry points with implementation dispatch.

``impl``:
  * "kernel"    — the hand-written CUDA kernel on CUDA tensors (no
                  fall-back: it launches or raises); the plain version on
                  CPU tensors, which is how the CPU tests reach it. On
                  either device it refuses an input that requires grad:
                  the kernels have no backward (``build.refuse_grad``);
  * "plain"     — the plain PyTorch version on whatever device the tensors
                  are on (the kernels' on-device yardstick, and the form
                  training differentiates);
  * "reference" — the oracles of ``ref.py`` (O(S^2) attention, token-by-
                  token recurrences; tests only).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_chunk as _k3
from repro_torch.kernels import ssd_chunk as _k4
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rwkv6_chunk import wkv6_plain
from repro_torch.kernels.ssd_chunk import ssd_plain

_decode_kernel = _k1.decode_attention
_flash_kernel = _k2.flash_attention
_wkv6_kernel = _k3.wkv6
_ssd_kernel = _k4.ssd
_KERNELS = {"decode_attention": _decode_kernel,
            "flash_attention": _flash_kernel,
            "wkv6": _wkv6_kernel,
            "ssd": _ssd_kernel}


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


def wkv6(r, k, v, w, u, initial_state=None, chunk=64, impl="kernel"):
    if impl == "kernel":
        return _wkv6_kernel(r, k, v, w, u, initial_state, chunk=chunk)
    if impl == "plain":
        return wkv6_plain(r, k, v, w, u, initial_state, chunk=chunk)
    if impl == "reference":
        return ref.wkv6_ref(r, k, v, w, u, initial_state)
    raise ValueError(impl)


def ssd(x, dt, A, B, C, D, initial_state=None, chunk=64, impl="kernel"):
    if impl == "kernel":
        return _ssd_kernel(x, dt, A, B, C, D, initial_state, chunk=chunk)
    if impl == "plain":
        return ssd_plain(x, dt, A, B, C, D, initial_state, chunk=chunk)
    if impl == "reference":
        return ref.ssd_ref(x, dt, A, B, C, D, initial_state)
    raise ValueError(impl)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
