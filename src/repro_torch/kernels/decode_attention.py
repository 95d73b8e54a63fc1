"""Flash-decode attention: one query token per row against a GQA KV cache.

Counterpart of ``repro.kernels.decode_attention`` (the Pallas TPU kernel) and
of ``repro.models.layers.decode_attention_jnp`` (its plain form). Three
things live here, as for every kernel of the port:

  * ``decode_attention_plain`` — the plain PyTorch version, used on CPU
    tensors, by the tests, and as the on-device yardstick of correctness;
  * ``decode_attention`` — the wrapper: on a CUDA tensor it launches the
    hand-written kernel ``csrc/decode_attention.cu`` or raises (there is no
    fall-back); on a CPU tensor it takes the plain version;
  * ``decode_attention.launches`` — a plain integer, one more per kernel
    launch, so a run can show that it went through the kernel.

``cache_len`` may be a Python int, a 0-d tensor or a ``(B,)`` tensor (one
length per batch row, what continuous batching passes).

A row with ``cache_len == 0`` yields zeros, in the kernel and in the plain
version alike. That follows the Pallas body, which skips every block and
divides a zero accumulator by ``max(l, 1e-20)``; ``decode_attention_jnp``
instead softmaxes a row of -1e30 into a uniform average of the cache. The
model never asks for it (it attends over ``cache_len + 1`` positions).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import NEG_INF

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)


def _lens_tensor(cache_len, b: int, device) -> torch.Tensor:
    """Scalar or (B,) lengths -> a contiguous (B,) int32 tensor on device."""
    if not torch.is_tensor(cache_len):
        return torch.full((b,), int(cache_len), dtype=torch.int32,
                          device=device)
    lens = cache_len.to(device=device, dtype=torch.int32)
    if lens.ndim == 0 or lens.numel() == 1:
        lens = lens.reshape(1).expand(b)
    elif lens.shape != (b,):
        raise ValueError(f"cache_len must be a scalar or ({b},), got "
                         f"{tuple(lens.shape)}")
    return lens.contiguous()


def decode_attention_plain(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); cache_len scalar or (B,).
    GQA-native masked softmax in fp32; output in q's dtype."""
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    lens = _lens_tensor(cache_len, b, q.device)
    qg = q.reshape(b, 1, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    mask = torch.arange(smax, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    out = out * (lens > 0).to(out.dtype)[:, None, None, None, None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _check(q, k_cache, v_cache) -> None:
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError("caches must both be (B, Smax, Hkv, D) matching q: "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not taken (float32 or bfloat16)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: dtype/device differ from q's")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    _check(q, k_cache, v_cache)
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    lens = _lens_tensor(cache_len, b, q.device)
    out = torch.empty_like(q)
    lib = build.load()
    with build.on_device(q.device):
        code = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), b, smax, hq, hkv, d,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
