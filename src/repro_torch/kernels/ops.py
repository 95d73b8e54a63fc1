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

import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import fused_decode as _fused
from repro_torch.kernels import grouped_gemm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_chunk as _k3
from repro_torch.kernels import ssd_chunk as _k4
from repro_torch.kernels import wkv6_decode as _k3d
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.fused_decode import (add_rms_norm_plain,
                                              rope_kv_write_plain,
                                              silu_mul_plain)
from repro_torch.kernels.grouped_gemm import (grouped_matmul_plain,
                                              grouped_swiglu_plain)
from repro_torch.kernels.rwkv6_chunk import wkv6_plain
from repro_torch.kernels.ssd_chunk import ssd_plain
from repro_torch.kernels.wkv6_decode import kept, wkv6_decode_plain

_decode_kernel = _k1.decode_attention
_flash_kernel = _k2.flash_attention
_wkv6_kernel = _k3.wkv6
_wkv6_decode_kernel = _k3d.wkv6_decode
_ssd_kernel = _k4.ssd
_grouped_kernel = _gmm.grouped_matmul
_swiglu_kernel = _gmm.grouped_swiglu
_add_rms_norm_kernel = _fused.add_rms_norm
_rope_kv_write_kernel = _fused.rope_kv_write
_silu_mul_kernel = _fused.silu_mul
_KERNELS = {"decode_attention": _decode_kernel,
            "flash_attention": _flash_kernel,
            "wkv6": _wkv6_kernel,
            "ssd": _ssd_kernel,
            "grouped_matmul": _grouped_kernel,
            "grouped_swiglu": _swiglu_kernel,
            "wkv6_decode": _wkv6_decode_kernel,
            "add_rms_norm": _add_rms_norm_kernel,
            "rope_kv_write": _rope_kv_write_kernel,
            "silu_mul": _silu_mul_kernel}


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


def decode_attention(q, k_cache, v_cache, cache_len, impl="kernel",
                     return_lse=False):
    if impl == "kernel":
        return _decode_kernel(q, k_cache, v_cache, cache_len,
                              return_lse=return_lse)
    if impl == "plain":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      return_lse)
    if impl == "reference":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                        return_lse)
    raise ValueError(impl)


def wkv6(r, k, v, w, u, initial_state=None, chunk=64, impl="kernel"):
    if impl == "kernel":
        return _wkv6_kernel(r, k, v, w, u, initial_state, chunk=chunk)
    if impl == "plain":
        return wkv6_plain(r, k, v, w, u, initial_state, chunk=chunk)
    if impl == "reference":
        return ref.wkv6_ref(r, k, v, w, u, initial_state)
    raise ValueError(impl)


def wkv6_decode(r, k, v, w, u, state, cache_len, impl="kernel"):
    """One token of WKV6 from ``state`` (B, H, dk, dv), the layer's slice
    of the cache, which every form writes in place: r, k, w (B, 1, H, dk),
    v (B, 1, H, dv), u (H, dk), cache_len a scalar or (B,) -> y (B, 1, H,
    dv) fp32. A row whose ``cache_len`` is 0 starts from zero state."""
    if impl == "kernel":
        return _wkv6_decode_kernel(r, k, v, w, u, state, cache_len)
    if impl == "plain":
        return wkv6_decode_plain(r, k, v, w, u, state, cache_len)
    if impl == "reference":
        y, new_state = ref.wkv6_ref(r, k, v, w, u, kept(state, cache_len))
        state.copy_(new_state)
        return y
    raise ValueError(impl)


def ssd(x, dt, A, B, C, D, initial_state=None, chunk=64, impl="kernel"):
    if impl == "kernel":
        return _ssd_kernel(x, dt, A, B, C, D, initial_state, chunk=chunk)
    if impl == "plain":
        return ssd_plain(x, dt, A, B, C, D, initial_state, chunk=chunk)
    if impl == "reference":
        return ref.ssd_ref(x, dt, A, B, C, D, initial_state)
    raise ValueError(impl)


def grouped_matmul(x, w, group_sizes, impl="kernel"):
    """``lax.ragged_dot(x, w, group_sizes)``: x (C, K) rows sorted by
    expert, w (E, K, N), group_sizes (E,) -> (C, N), rows past the last
    group 0."""
    if impl == "kernel":
        return _grouped_kernel(x, w, group_sizes)
    if impl == "plain":
        return grouped_matmul_plain(x, w, group_sizes)
    if impl == "reference":
        return ref.grouped_matmul_ref(x, w, group_sizes)
    raise ValueError(impl)


def grouped_swiglu(x, w_gate, w_up, group_sizes, impl="kernel"):
    """The MoE's ``h``: ``silu(g) * u`` of ``g = grouped_matmul(x, w_gate)``
    and ``u = grouped_matmul(x, w_up)``, each rounded to x's dtype first;
    the kernel fuses the two products and the epilogue into one launch."""
    if impl == "kernel":
        return _swiglu_kernel(x, w_gate, w_up, group_sizes)
    if impl == "plain":
        return grouped_swiglu_plain(x, w_gate, w_up, group_sizes)
    if impl == "reference":
        g = ref.grouped_matmul_ref(x, w_gate, group_sizes)
        u = ref.grouped_matmul_ref(x, w_up, group_sizes)
        return (F.silu(g.float()) * u.float()).to(x.dtype)
    raise ValueError(impl)


# The fused passes of DecoderLM's decode step: their plain forms are the
# composition they replace, so "plain" and "reference" are one form.

def add_rms_norm(x, delta, weight, eps=1e-6, impl="kernel"):
    """``(x + delta, rms_norm(x + delta, weight, eps))`` (``delta`` None:
    ``(x, rms_norm(x, weight, eps))``)."""
    if impl == "kernel":
        return _add_rms_norm_kernel(x, delta, weight, eps)
    if impl in ("plain", "reference"):
        return add_rms_norm_plain(x, delta, weight, eps)
    raise ValueError(impl)


def rope_kv_write(q, k, v, cos, sin, k_cache, v_cache, cache_len,
                  impl="kernel"):
    """q (B,1,Hq,D) and k (B,1,Hkv,D) rotated by the (B,1,1,D/2) tables,
    the rotated k and v written into the layer's caches (B,Smax,Hkv,D) at
    each row's ``cache_len`` (B,) -> the rotated q."""
    if impl == "kernel":
        return _rope_kv_write_kernel(q, k, v, cos, sin, k_cache, v_cache,
                                     cache_len)
    if impl in ("plain", "reference"):
        return rope_kv_write_plain(q, k, v, cos, sin, k_cache, v_cache,
                                   cache_len)
    raise ValueError(impl)


def silu_mul(g, u, impl="kernel"):
    """``F.silu(g) * u``, each rounded to g's dtype."""
    if impl == "kernel":
        return _silu_mul_kernel(g, u)
    if impl in ("plain", "reference"):
        return silu_mul_plain(g, u)
    raise ValueError(impl)


# -- launch counters ------------------------------------------------------------
#
# Each wrapper adds one to its count where it launches its kernel. A CUDA
# graph replay calls no wrapper, so a captured decode step
# (``serving/exec_cache.py``) records what its capture counted
# (``launch_delta``), takes it back (a capture is not a run) and adds it at
# every replay (``add_launches``).

def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Launches counted since ``before`` (a ``launch_counts()``), by kernel;
    kernels that did not move are left out."""
    now = launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` (by kernel name) ``times`` over to the counters."""
    for name, n in counts.items():
        _KERNELS[name].launches += n * times


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
