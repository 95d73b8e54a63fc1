"""Shared model components: norms, rotary embeddings, attention, MLPs.

Plain functions on tensors, one per function of ``repro.models.layers`` with
the same name, argument order and ``(B, S, H, D)`` shape convention. The
blocked attention forms live beside their kernels in
``repro_torch.kernels`` (``flash_attention_plain``,
``decode_attention_plain``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

NEG_INF = -1e30   # finite on purpose: exp(NEG_INF - NEG_INF) is 1, not NaN


# -- initializers -------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Normal(0, scale) draw; ``scale`` defaults to 1/sqrt(shape[0]) as in
    the reference (which is handed stacked ``(L, ...)`` shapes, so the
    fan-in of a layer matrix is ``L`` there and here)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# -- norms --------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics, fp32 weight, cast back to the input dtype last."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(dt)


# -- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """cos and sin of the rotary angles, each (B, S, 1, D/2) in fp32, for
    positions (B, S) int. They depend on the positions only, so a model
    computes them once per step and shares them across its layers."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (B,S,D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (B, S, H, D) by tables from ``rope_tables``;
    computed in fp32, returned in x's dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding. x: (B, S, H, D); positions: (B, S) int;
    angles are computed in fp32."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def mrope_tables(positions: torch.Tensor, head_dim: int,
                 sections: Sequence[int], theta: float = 10000.0):
    """``rope_tables`` for multimodal RoPE (Qwen2-VL): the head_dim/2
    frequencies are split into (t, h, w) sections, each turned by its own
    position stream. positions: (B, S, 3) int."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    lead = positions.shape[:-1]
    pos = torch.cat([positions[..., i, None].expand(*lead, n)
                     for i, n in enumerate(sections)], dim=-1)    # (B,S,D/2)
    angles = pos.to(torch.float32) * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE. x: (B, S, H, D); positions: (B, S, 3) int; angles
    in fp32, output in x's dtype."""
    return rotate(x, *mrope_tables(positions, x.shape[-1], sections, theta))


# -- attention ----------------------------------------------------------------

def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def attention_reference(q, k, v, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """O(S^2)-memory oracle. q: (B,Sq,H,D), k/v: (B,Skv,H,D)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where((ki <= qi)[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


# -- MLPs ---------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    """tanh-approximate GELU, the reference's (``jax.nn.gelu`` default)."""
    h = torch.matmul(x, w_up) + b_up
    out = torch.matmul(F.gelu(h, approximate="tanh").to(x.dtype), w_down)
    return (out + b_down).to(x.dtype)


# -- training -----------------------------------------------------------------

def next_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``loss_fn`` arithmetic: fp32 logits,
    ``logsumexp - gold``, mean over every position."""
    logits = logits.float()
    labels = labels.to(device=logits.device, dtype=torch.long)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


# -- decode lengths -----------------------------------------------------------

def one_cache_len(cache_len: torch.Tensor, who: str) -> torch.Tensor:
    """One length for the whole batch, as a 0-d long tensor: a scalar, or a
    (B,) tensor whose entries are equal. The reference writes such a
    model's caches with one scalar ``dynamic_update_slice``, so per-row
    lengths that differ raise (ROADMAP §C2) instead of being misread.
    Comparing the entries reads them on the host."""
    if cache_len.ndim:
        if bool((cache_len != cache_len.reshape(-1)[0]).any()):
            raise ValueError(
                f"{who}.decode_step takes one cache_len for the whole "
                "batch, as the reference does; per-row lengths are not "
                "supported (ROADMAP §C2)")
        cache_len = cache_len.reshape(-1)[0]
    return cache_len.long()
