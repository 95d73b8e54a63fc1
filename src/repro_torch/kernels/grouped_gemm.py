"""Grouped GEMM over expert groups: the counterpart of ``lax.ragged_dot``.

``repro.models.moe._local_moe`` multiplies its expert-sorted rows by their
experts' matrices with ``lax.ragged_dot(x, w, group_sizes)`` (an XLA
primitive, not a Pallas kernel), three times a layer. As for every kernel
of the port, three things live here:

  * ``grouped_matmul_plain`` — the plain PyTorch version:
    ``chunked.grouped_matmul_loop``, a loop of ``torch.matmul`` over the
    contiguous groups. It reads the group sizes on
    the host (one synchronisation a call on the card); the CPU tests and
    training (``attn_impl="plain"``) take it;
  * ``grouped_matmul`` — the wrapper: on a CUDA tensor it launches the
    hand-written kernel ``csrc/grouped_gemm.cu``, which reads the sizes and
    their prefix sum on the device, so the call never waits for the card and
    a decode step through it can be captured as a CUDA graph; on a CPU
    tensor it takes the plain version;
  * ``grouped_matmul.launches`` — one more per kernel launch.

Semantics (both forms): ``x`` (C, K) with its rows sorted by expert, ``w``
(E, K, N), ``group_sizes`` (E,) integers summing to at most C; the result
(C, N) in ``x``'s dtype, accumulated in fp32, row ``r`` of group ``e`` being
``x[r] @ w[e]`` and every row past the last group 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunked import grouped_matmul_loop

# the plain version is the loop over the groups
grouped_matmul_plain = grouped_matmul_loop


def _check(x, w, group_sizes) -> None:
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (C, K) and w (E, K, N): "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    if group_sizes.shape != (w.shape[0],):
        raise ValueError(f"group_sizes must be ({w.shape[0]},), got "
                         f"{tuple(group_sizes.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not taken (float32 or bfloat16)")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x {x.dtype}")
    vec = 16 // x.element_size()
    if w.shape[2] % vec:
        raise ValueError(f"N = {w.shape[2]} is not a multiple of {vec} "
                         "(the kernel's 16-byte vectors)")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise TypeError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")


def grouped_matmul(x, w, group_sizes):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    build.refuse_grad("grouped_matmul", x, w)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    _check(x, w, group_sizes)
    C, K = x.shape
    E, _, N = w.shape
    sizes = group_sizes if group_sizes.dtype == torch.int64 \
        else group_sizes.to(torch.int64)
    out = torch.empty((C, N), dtype=x.dtype, device=x.device)
    if C == 0:
        return out
    lib = build.load()
    with build.on_device(x.device):
        code = lib.repro_grouped_gemm(
            x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            C, K, N, E, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, code, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
