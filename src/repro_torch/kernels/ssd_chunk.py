"""Chunk-parallel Mamba-2 SSD scan (the zamba2 mixer).

Counterpart of ``repro.kernels.ssd_chunk`` (the Pallas TPU kernel
``ssd_pallas``):

  * ``ssd_plain`` — the plain PyTorch version: the chunked matmul form of
    ``chunked.ssd_chunked``, used on CPU tensors, by the tests, and as the
    on-device yardstick of correctness;
  * ``ssd`` — the wrapper: on a CUDA tensor it launches the hand-written
    kernel ``csrc/ssd_chunk.cu`` or raises (there is no fall-back); on a CPU
    tensor it takes the plain version;
  * ``ssd.launches`` — one more per kernel launch.

Shapes: x (b, S, H, P); dt (b, S, H); A, D (H,); B, C (b, S, H, N); state
(b, H, P, N). The kernel takes x, B and C in float32 or bfloat16 (one dtype)
through their strides, as long as the last dimension is contiguous — the
model hands over B and C as one (b, S, N) tensor broadcast over heads (head
stride 0) and x as a view into the conv output, and nothing is copied. dt,
A, D and the state are float32; N <= 64; a chunk of at most 64 positions
dividing S. It returns (y (b, S, H, P), final state), both float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunked import ssd_chunked

MAX_CHUNK = 64
MAX_N = 64

# the plain version is the chunked form itself
ssd_plain = ssd_chunked


def _check_chunk(s, chunk) -> None:
    """Both paths take the same chunks (at most 64, dividing S)."""
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S={s}")


def _check(x, dt, A, B, C, D) -> None:
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3] or dt.shape != x.shape[:3]:
        raise ValueError("x must be (b,S,H,P), dt (b,S,H), B and C "
                         f"(b,S,H,N): {tuple(x.shape)} {tuple(dt.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    h = x.shape[2]
    if A.shape != (h,) or D.shape != (h,):
        raise ValueError(f"A and D must be ({h},)")
    if B.shape[-1] > MAX_N:
        raise ValueError(f"N {B.shape[-1]} > {MAX_N}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not taken (float32 or bfloat16)")
    for name, t, want in (("B", B, x.dtype), ("C", C, x.dtype),
                          ("dt", dt, torch.float32), ("A", A, torch.float32),
                          ("D", D, torch.float32)):
        if t.dtype != want or t.device != x.device:
            raise TypeError(f"{name}: dtype {t.dtype} / device {t.device}, "
                            f"want {want} on {x.device}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    for name, t in (("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd(x, dt, A, B, C, D, initial_state=None, chunk: int = 64,
        design: int = 0):
    """Kernel on CUDA tensors, plain version on CPU tensors. ``design``
    (CUDA only, for timing) forces one of the kernel's block shapes
    (``repro_ssd_chunk`` in ``csrc/ssd_chunk.cu``); 0 lets it choose."""
    build.refuse_grad("ssd", x, dt, A, B, C, D, initial_state)
    chunk = int(chunk)
    _check_chunk(x.shape[1], chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, D, initial_state, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    _check(x, dt, A, B, C, D)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if initial_state is None:
        h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    else:
        h0 = initial_state.to(device=x.device,
                              dtype=torch.float32).contiguous()
        if h0.shape != (b, h, p, n):
            raise ValueError(f"initial_state must be ({b}, {h}, {p}, {n})")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    with build.on_device(x.device):
        code = lib.repro_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), b, s, h, p, n, chunk,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            int(x.dtype == torch.bfloat16), int(design),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, code, "ssd")
    ssd.launches += 1
    return y, h_out


ssd.launches = 0
