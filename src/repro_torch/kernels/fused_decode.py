"""Three fused passes of ``DecoderLM``'s one-device decode step.

The non-product work around a decode layer's products: the residual add
with the RMSNorm after it, the rotary embedding with the KV-cache write,
and ``silu(g) * u``. No TPU kernel to replace: the reference leaves these
passes to XLA, which fuses them. In the port's captured step each was a
chain of small PyTorch kernels, and the graph's nodes, not its bytes, set
the step's time (``csrc/fused_decode.cu`` says more). Three things live
here for each pass, as for every kernel of the port:

  * the plain form (``add_rms_norm_plain``, ``rope_kv_write_plain``,
    ``silu_mul_plain``): literally the composition the unfused decode step
    runs (``x + delta`` then ``layers.rms_norm``; ``layers.rotate`` then
    ``index_put_``; ``F.silu(g) * u``), so a CPU run is bit for bit the
    unfused step's. The CPU tests reach it, and ``chip_smoke.py`` holds
    each kernel against it;
  * the wrapper (``add_rms_norm``, ``rope_kv_write``, ``silu_mul``): on a
    CUDA tensor it launches the kernel or raises (there is no fall-back);
    on a CPU tensor it takes the plain form; either way it refuses an
    input that requires grad;
  * ``<wrapper>.launches`` — one more per kernel launch.

Each kernel rounds where its plain form rounds (``csrc/fused_decode.cu``),
and takes float32 or bfloat16 activations (one dtype), float32 norm weights
and rotary tables, contiguous tensors on one device, 16-byte aligned where
they are read 16 bytes at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.models import layers as L

MAX_HEAD_DIM = 128
NORM_MAX_VECTORS = 4096    # 16-byte vectors a row (the kernel's 8 x 512)
DTYPES = (torch.float32, torch.bfloat16)


# -- plain forms ----------------------------------------------------------------

def add_rms_norm_plain(x, delta, weight, eps=1e-6):
    """``(x + delta, rms_norm(x + delta, weight))``; ``delta`` None adds
    nothing (the first layer's norm)."""
    if delta is not None:
        x = x + delta
    return x, L.rms_norm(x, weight, eps)


def rope_kv_write_plain(q, k, v, cos, sin, k_cache, v_cache, cache_len):
    """q and k rotated (``layers.rotate``), the rotated k and v written at
    ``[b, cache_len[b]]`` of the layer's caches; returns the rotated q."""
    q = L.rotate(q, cos, sin)
    k = L.rotate(k, cos, sin)
    write_at = (torch.arange(q.shape[0], device=q.device), cache_len)
    k_cache.index_put_(write_at, k[:, 0])
    v_cache.index_put_(write_at, v[:, 0])
    return q


def silu_mul_plain(g, u):
    return F.silu(g) * u


# -- checks -----------------------------------------------------------------------

def _on(ref, what, **tensors) -> None:
    """dtype, device and contiguity of ``tensors`` against ``ref``'s."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or t.device != ref.device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                            f"want {dtype} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _aligned(what, **tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _dtype(what, t) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not taken (float32 or "
                        "bfloat16)")


def _check_norm(x, delta, weight) -> None:
    _dtype("add_rms_norm", x)
    d = x.shape[-1]
    if d % 8 or d // (16 // x.element_size()) > NORM_MAX_VECTORS:
        raise ValueError(f"add_rms_norm: hidden size {d} not taken (a "
                         f"multiple of 8, at most {NORM_MAX_VECTORS} "
                         "16-byte vectors)")
    if weight.shape != (d,) or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, "
                         f"weight {tuple(weight.shape)}")
    ts = {"x": (x, x.dtype), "weight": (weight, torch.float32)}
    if delta is not None:
        ts["delta"] = (delta, x.dtype)
    _on(x, "add_rms_norm", **ts)
    _aligned("add_rms_norm", **{n: t for n, (t, _) in ts.items()})


def _check_rope(q, k, v, cos, sin, k_cache, v_cache, cache_len) -> None:
    what = "rope_kv_write"
    _dtype(what, q)
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: q must be (B,1,Hq,D) and k, v (B,1,Hkv,D)"
                         f": {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, _, _, d = q.shape
    hkv = k.shape[2]
    if d % 2 or not 2 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} not taken (even, at most "
                         f"{MAX_HEAD_DIM})")
    if cos.shape != (b, 1, 1, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"{what}: cos and sin must be ({b}, 1, 1, {d // 2})"
                         f": {tuple(cos.shape)} {tuple(sin.shape)}")
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[2:] != (hkv, d):
        raise ValueError(f"{what}: caches must both be (B, Smax, {hkv}, {d})"
                         f": {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if cache_len.shape != (b,):
        raise ValueError(f"{what}: cache_len must be ({b},), got "
                         f"{tuple(cache_len.shape)}")
    dt = q.dtype
    _on(q, what, q=(q, dt), k=(k, dt), v=(v, dt), cos=(cos, torch.float32),
        sin=(sin, torch.float32), k_cache=(k_cache, dt),
        v_cache=(v_cache, dt), cache_len=(cache_len, torch.int64))


def _check_silu(g, u) -> None:
    _dtype("silu_mul", g)
    if u.shape != g.shape or g.numel() % 8:
        raise ValueError(f"silu_mul: g {tuple(g.shape)} and u "
                         f"{tuple(u.shape)} must match, with a multiple of 8 "
                         "values")
    _on(g, "silu_mul", g=(g, g.dtype), u=(u, g.dtype))
    _aligned("silu_mul", g=g, u=u)


def _device(what, t) -> bool:
    """True for a CPU tensor (the plain form runs); False for a CUDA one
    (the kernel launches); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")
    return False


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- wrappers ---------------------------------------------------------------------

def add_rms_norm(x, delta, weight, eps=1e-6):
    """``(x + delta, rms_norm(x + delta, weight, eps))`` over x's last axis
    (``delta`` None: ``(x, rms_norm(x, weight, eps))``); the kernel on CUDA
    tensors, the plain form on CPU tensors."""
    build.refuse_grad("add_rms_norm", x, delta, weight)
    if _device("add_rms_norm", x):
        return add_rms_norm_plain(x, delta, weight, eps)
    _check_norm(x, delta, weight)
    d = x.shape[-1]
    h = torch.empty_like(x)
    out = x if delta is None else torch.empty_like(x)
    lib = build.load()
    with build.on_device(x.device):
        code = lib.repro_add_rms_norm(
            x.data_ptr(), None if delta is None else delta.data_ptr(),
            weight.data_ptr(), None if delta is None else out.data_ptr(),
            h.data_ptr(), x.numel() // d, d, eps,
            int(x.dtype == torch.bfloat16), _stream(x))
    build.check_launch(lib, code, "add_rms_norm")
    add_rms_norm.launches += 1
    return out, h


def rope_kv_write(q, k, v, cos, sin, k_cache, v_cache, cache_len):
    """q (B,1,Hq,D) and k (B,1,Hkv,D) rotated by the (B,1,1,D/2) tables,
    the rotated k and v (B,1,Hkv,D) written into the layer's caches
    (B,Smax,Hkv,D) at each row's ``cache_len`` (B,) int64; returns the
    rotated q. The kernel on CUDA tensors (a position outside the cache
    writes nothing), the plain form on CPU tensors."""
    build.refuse_grad("rope_kv_write", q, k, v, cos, sin, k_cache, v_cache)
    if _device("rope_kv_write", q):
        return rope_kv_write_plain(q, k, v, cos, sin, k_cache, v_cache,
                                   cache_len)
    _check_rope(q, k, v, cos, sin, k_cache, v_cache, cache_len)
    b, _, hq, d = q.shape
    out = torch.empty_like(q)
    lib = build.load()
    with build.on_device(q.device):
        code = lib.repro_rope_kv_write(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), b, hq, k.shape[2], d,
            k_cache.shape[1], int(q.dtype == torch.bfloat16), _stream(q))
    build.check_launch(lib, code, "rope_kv_write")
    rope_kv_write.launches += 1
    return out


def silu_mul(g, u):
    """``F.silu(g) * u``; the kernel on CUDA tensors, the plain form on CPU
    tensors."""
    build.refuse_grad("silu_mul", g, u)
    if _device("silu_mul", g):
        return silu_mul_plain(g, u)
    _check_silu(g, u)
    out = torch.empty_like(g)
    lib = build.load()
    with build.on_device(g.device):
        code = lib.repro_silu_mul(g.data_ptr(), u.data_ptr(), out.data_ptr(),
                                  g.numel(), int(g.dtype == torch.bfloat16),
                                  _stream(g))
    build.check_launch(lib, code, "silu_mul")
    silu_mul.launches += 1
    return out


add_rms_norm.launches = 0
rope_kv_write.launches = 0
silu_mul.launches = 0
