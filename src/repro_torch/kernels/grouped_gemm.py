"""Grouped GEMM over expert groups: the counterpart of ``lax.ragged_dot``,
and the fused gate/up pass of the MoE's expert FFN.

``repro.models.moe._local_moe`` multiplies its expert-sorted rows by their
experts' matrices with ``lax.ragged_dot(x, w, group_sizes)`` (an XLA
primitive, not a Pallas kernel), three times a layer, with
``silu(g) * u`` between the gate/up pair and the down projection. As for
every kernel of the port, three things live here for each of the two ops:

  * ``grouped_matmul_plain`` — the plain PyTorch version:
    ``chunked.grouped_matmul_loop``, a loop of ``torch.matmul`` over the
    contiguous groups. It reads the group sizes on
    the host (one synchronisation a call on the card); the CPU tests and
    training (``attn_impl="plain"``) take it. ``grouped_swiglu_plain``
    composes it twice with the reference's epilogue;
  * ``grouped_matmul`` / ``grouped_swiglu`` — the wrappers: on a CUDA
    tensor they launch the hand-written kernels of ``csrc/grouped_gemm.cu``,
    which read the sizes and their prefix sum on the device, so a call never
    waits for the card and a decode step through it can be captured as a
    CUDA graph; on a CPU tensor they take the plain versions;
  * ``grouped_matmul.launches`` / ``grouped_swiglu.launches`` — one more
    per kernel launch.

Semantics (every form): ``x`` (C, K) with its rows sorted by expert, ``w``
(E, K, N), ``group_sizes`` (E,) integers summing to at most C; the result
(C, N) in ``x``'s dtype, accumulated in fp32, row ``r`` of group ``e`` being
``x[r] @ w[e]`` and every row past the last group 0. ``grouped_swiglu(x,
w_gate, w_up, group_sizes)`` is ``silu(g) * u`` of the two grouped products
``g`` and ``u``, each rounded to ``x``'s dtype first (``lax.ragged_dot``
returns it), the product taken in fp32 and rounded once, as the reference
computes ``h`` (``src/repro/models/moe.py:128-131``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.chunked import grouped_matmul_loop

# the plain version is the loop over the groups
grouped_matmul_plain = grouped_matmul_loop


def grouped_swiglu_plain(x, w_gate, w_up, group_sizes):
    """The reference's ``h``: two grouped products, each in ``x``'s dtype,
    then ``silu(g) * u`` in fp32, rounded once."""
    g = grouped_matmul_plain(x, w_gate, group_sizes)
    u = grouped_matmul_plain(x, w_up, group_sizes)
    return (F.silu(g.float()) * u.float()).to(x.dtype)


def _check(x, ws, group_sizes) -> None:
    for w in ws:
        if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
            raise ValueError(f"x must be (C, K) and w (E, K, N): "
                             f"{tuple(x.shape)} / {tuple(w.shape)}")
        if w.shape != ws[0].shape:
            raise ValueError(f"w_gate and w_up differ: {tuple(ws[0].shape)} "
                             f"/ {tuple(w.shape)}")
        if w.dtype != x.dtype:
            raise TypeError(f"w is {w.dtype}, x {x.dtype}")
        if w.data_ptr() % 16:
            raise ValueError("w must be 16-byte aligned")
    if group_sizes.shape != (ws[0].shape[0],):
        raise ValueError(f"group_sizes must be ({ws[0].shape[0]},), got "
                         f"{tuple(group_sizes.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not taken (float32 or bfloat16)")
    vec = 16 // x.element_size()
    if ws[0].shape[2] % vec:
        raise ValueError(f"N = {ws[0].shape[2]} is not a multiple of {vec} "
                         "(the kernel's 16-byte vectors)")
    for name, t in (("x", x), ("group_sizes", group_sizes),
                    *(("w", w) for w in ws)):
        if t.device != x.device:
            raise TypeError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# The bf16 kernels may cut K into up to MAX_SPLIT parts (they choose on the
# device, from the work list) and add the parts' fp32 sums in a second pass,
# in part order; their scratch is bounded by SPLIT_SCRATCH_BYTES, so a wide
# call (a prefill's thousands of rows) splits less or not at all.
MAX_SPLIT = 4
SPLIT_SCRATCH_BYTES = 32 << 20


def _launch(what, entry, x, ws, group_sizes):
    """Checks, allocates the output and scratch and launches ``entry`` on
    the current stream; returns the output."""
    _check(x, ws, group_sizes)
    C, K = x.shape
    E, _, N = ws[0].shape
    sizes = group_sizes if group_sizes.dtype == torch.int64 \
        else group_sizes.to(torch.int64)
    out = torch.empty((C, N), dtype=x.dtype, device=x.device)
    if C == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    plane = len(ws) * C * N * 4
    max_split = max(1, min(MAX_SPLIT, SPLIT_SCRATCH_BYTES // plane)) \
        if bf16 else 1
    partial = torch.empty((len(ws) * max_split * C * N if max_split > 1
                           else 0,), dtype=torch.float32, device=x.device)
    info = torch.empty((2,), dtype=torch.int32, device=x.device)
    lib = build.load()
    # the bf16 kernels' persistent grid: two blocks per SM
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with build.on_device(x.device):
        code = getattr(lib, entry)(
            x.data_ptr(), *(w.data_ptr() for w in ws), sizes.data_ptr(),
            out.data_ptr(), partial.data_ptr(), info.data_ptr(), max_split,
            C, K, N, E, int(bf16), sms,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, code, what)
    return out


def grouped_matmul(x, w, group_sizes):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    build.refuse_grad("grouped_matmul", x, w)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    out = _launch("grouped_matmul", "repro_grouped_gemm", x, (w,),
                  group_sizes)
    if x.shape[0]:
        grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_swiglu(x, w_gate, w_up, group_sizes):
    """The fused gate/up pass: kernel on CUDA tensors, plain version on CPU
    tensors. Reads each row of ``x`` once for both matrices; ``g`` and ``u``
    never reach device memory."""
    build.refuse_grad("grouped_swiglu", x, w_gate, w_up)
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, w_gate, w_up, group_sizes)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    out = _launch("grouped_swiglu", "repro_grouped_swiglu", x,
                  (w_gate, w_up), group_sizes)
    if x.shape[0]:
        grouped_swiglu.launches += 1
    return out


grouped_swiglu.launches = 0
