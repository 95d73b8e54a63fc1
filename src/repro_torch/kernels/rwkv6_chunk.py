"""Chunk-parallel RWKV6 (WKV) recurrence.

Counterpart of ``repro.kernels.rwkv6_chunk`` (the Pallas TPU kernel
``wkv6_pallas``). Three things live here, as for every kernel of the port:

  * ``wkv6_plain`` — the plain PyTorch version: the chunked matmul form of
    ``chunked.wkv6_chunked``, used on CPU tensors, by the tests, and as the
    on-device yardstick of correctness;
  * ``wkv6`` — the wrapper: on a CUDA tensor it launches the hand-written
    kernel ``csrc/rwkv6_chunk.cu`` or raises (there is no fall-back); on a
    CPU tensor it takes the plain version;
  * ``wkv6.launches`` — one more per kernel launch.

Shapes: r, k, w (B, S, H, dk); v (B, S, H, dv); u (H, dk); state
(B, H, dk, dv). The kernel takes r, k, v in float32 or bfloat16 (one dtype)
and w, u and the state in float32, each contiguous, dk <= 64 and a chunk of
at most 64 positions dividing S. It returns (y (B, S, H, dv), final state),
both float32, as the Pallas kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunked import wkv6_chunked

MAX_CHUNK = 64
MAX_DK = 64

# the plain version is the chunked form itself
wkv6_plain = wkv6_chunked


def _check_chunk(s, chunk) -> None:
    """Both paths take the same chunks: at most 64 keeps |log w| * chunk,
    the largest exponent of the chunked form, within fp32's exp range."""
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S={s}")


def _check(r, k, v, w, u) -> None:
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.ndim != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError("r, k, w must be (B,S,H,dk) and v (B,S,H,dv): "
                         f"{tuple(r.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} {tuple(w.shape)}")
    h, dk = r.shape[2:]
    if u.shape != (h, dk):
        raise ValueError(f"u must be ({h}, {dk}), got {tuple(u.shape)}")
    if dk > MAX_DK:
        raise ValueError(f"dk {dk} > {MAX_DK}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {r.dtype} not taken (float32 or bfloat16)")
    for name, t, dt in (("k", k, r.dtype), ("v", v, r.dtype),
                        ("w", w, torch.float32), ("u", u, torch.float32)):
        if t.dtype != dt or t.device != r.device:
            raise TypeError(f"{name}: dtype {t.dtype} / device {t.device}, "
                            f"want {dt} on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wkv6(r, k, v, w, u, initial_state=None, chunk: int = 64,
         design: int = 0):
    """Kernel on CUDA tensors, plain version on CPU tensors. ``design``
    (CUDA only, for timing) forces one of the kernel's block shapes
    (``repro_wkv6_chunk`` in ``csrc/rwkv6_chunk.cu``); 0 lets it choose."""
    build.refuse_grad("wkv6", r, k, v, w, u, initial_state)
    chunk = int(chunk)
    _check_chunk(r.shape[1], chunk)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, initial_state, chunk=chunk)
    if r.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {r.device}")
    _check(r, k, v, w, u)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if initial_state is None:
        s0 = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    else:
        s0 = initial_state.to(device=r.device,
                              dtype=torch.float32).contiguous()
        if s0.shape != (b, h, dk, dv):
            raise ValueError(f"initial_state must be ({b}, {h}, {dk}, {dv})")
    y = torch.empty((b, s, h, dv), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    lib = build.load()
    with build.on_device(r.device):
        code = lib.repro_wkv6_chunk(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            b, s, h, dk, dv, chunk, int(r.dtype == torch.bfloat16),
            int(design), torch.cuda.current_stream(r.device).cuda_stream)
    build.check_launch(lib, code, "wkv6")
    wkv6.launches += 1
    return y, s_out


wkv6.launches = 0
