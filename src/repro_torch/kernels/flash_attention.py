"""Blocked causal / non-causal GQA attention forward (prefill).

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel) and
of ``repro.models.layers.flash_attention_jnp`` (its plain form):

  * ``flash_attention_plain`` — blocked online-softmax attention in plain
    PyTorch (fp32 state, GQA-native, ragged tails handled, ``q_offset``
    shifting the causal diagonal); used on CPU tensors, by the tests, and as
    the on-device yardstick of correctness;
  * ``flash_attention`` — the wrapper: on a CUDA tensor it launches the
    hand-written kernel ``csrc/flash_attention.cu`` or raises (there is no
    fall-back); on a CPU tensor it takes the plain version;
  * ``flash_attention.launches`` — one more per kernel launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import NEG_INF

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)


def flash_attention_plain(q, k, v, causal: bool = True, q_chunk: int = 512,
                          kv_chunk: int = 1024,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    The FlashAttention recurrence over (q chunk, kv chunk) tiles with the
    reference's arithmetic: masked scores are -1e30 (not -inf), the running
    state is fp32, the result is ``acc / max(l, 1e-20)``. A ragged last
    chunk is simply shorter (the jnp form pads and masks, to the same
    effect); KV chunks wholly above the causal diagonal are skipped."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q_chunk = max(1, min(q_chunk, sq))
    kv_chunk = max(1, min(kv_chunk, skv))
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = qg[:, q0:q0 + q_chunk]                     # (B, cq, Hkv, G, D)
        cq = qi.shape[1]
        qpos = torch.arange(q0, q0 + cq, device=dev)[:, None] + q_offset
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, kv_chunk):
            if causal and k0 > q0 + cq - 1 + q_offset:
                break
            ki, vi = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
            if causal:
                kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)[None, :]
                s = torch.where((kpos <= qpos)[None, None, None], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vi)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _check(q, k, v, q_offset) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be (B,Sq,Hq,D) and k, v both (B,Skv,Hkv,D): "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("k/v batch or head_dim differ from q's")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not taken (float32 or bfloat16)")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: dtype/device differ from q's")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Kernel on CUDA tensors (its tile sizes are its own; the chunk
    arguments steer the plain version only), plain version on CPU tensors."""
    build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.load()
    with build.on_device(q.device):
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, d, int(bool(causal)), q_offset,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
