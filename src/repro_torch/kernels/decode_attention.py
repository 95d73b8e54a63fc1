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
length per batch row, what continuous batching passes). The lengths stay on
the device: the kernel's split of the KV axis over blocks (``split_plan``)
is chosen from the shapes alone, so a call never waits for the card.

With ``return_lse=True`` both also return each row's log-sum-exp of the
scaled scores, ``(B, Hq)`` in fp32 (``m + log l`` of the row's final
softmax state; ``-inf`` for a row of length 0): what a caller needs to merge
partial attentions over several slices of one cache, as the sequence-sharded
decode (``models/distributed_attention.py``) does across ranks.

A row with ``cache_len == 0`` yields zeros, in the kernel and in the plain
version alike. That follows the Pallas body, which skips every block and
divides a zero accumulator by ``max(l, 1e-20)``; ``decode_attention_jnp``
instead softmaxes a row of -1e30 into a uniform average of the cache. The
model never asks for it (it attends over ``cache_len + 1`` positions).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import NEG_INF

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)
SMS = 132                 # streaming multiprocessors of an H100
WARPS = 8                 # warps a block (the kernel's NW)
BLOCKS_PER_SM = 2         # blocks the split aims at, per SM
MAX_SPLIT = 64            # splits of one row at most (the kernel's limit)
_COUNTERS = {}            # device index -> [int32 split counters, all 0]


def heads_per_block(g: int) -> int:
    """Query heads one block handles: the largest of {8, 6, 4, 3, 2, 1}
    that divides the group size (the kernel's own rule)."""
    return next(c for c in (8, 6, 4, 3, 2, 1) if g % c == 0)


def split_plan(b: int, hq: int, hkv: int, smax: int,
               sms: int = SMS) -> tuple:
    """How the kernel splits each (row, KV head, head group) over blocks,
    from shapes only (never the lengths): ``(nsplit, chunk)``, split ``s``
    covering positions ``[s * chunk, min((s + 1) * chunk, smax))``.

    When the groups alone give a block per SM, nothing is split: one block
    per group (the single-pass path, no scratch). Otherwise the groups are
    split until there are about ``BLOCKS_PER_SM * sms`` blocks, but no split
    is shorter than one 32-position tile per warp of its ``WARPS`` warps;
    ``chunk`` is the multiple of that nearest ``smax / nsplit``, so every
    warp starts on a tile of its own."""
    units = b * hkv * (hq // hkv // heads_per_block(hq // hkv))
    tile = 32 * WARPS
    want = min(-(-BLOCKS_PER_SM * sms // units), -(-smax // tile),
               MAX_SPLIT)
    if units >= sms or want <= 1:
        return 1, smax
    chunk = max(1, int(smax / want / tile + 0.5)) * tile
    if -(-smax // chunk) > MAX_SPLIT:
        chunk = -(-smax // (MAX_SPLIT * tile)) * tile
    return -(-smax // chunk), chunk


def _index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device, n: int) -> torch.Tensor:
    """The device's split counters (at least ``n``). They are made zeroed
    outside any CUDA-graph capture and every launch leaves them at 0, so a
    captured launch may use them; a first use inside a capture raises. A
    buffer outgrown is kept, not freed: a graph captured on it stays
    valid."""
    bufs = _COUNTERS.setdefault(_index(device), [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: the split counters of this device are "
                "first needed inside a CUDA-graph capture; make one call "
                "at this size before capturing")
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]


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


def decode_attention_plain(q, k_cache, v_cache, cache_len,
                           return_lse: bool = False):
    """q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); cache_len scalar or (B,).
    GQA-native masked softmax in fp32; output in q's dtype. With
    ``return_lse`` also the rows' log-sum-exp, (B, Hq) fp32."""
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
    out = out.reshape(b, 1, hq, d).to(q.dtype)
    if not return_lse:
        return out
    live = torch.where(mask[:, None, None, None, :], s,
                       torch.full_like(s, -math.inf))
    return out, torch.logsumexp(live, dim=-1).reshape(b, hq)


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


def decode_attention(q, k_cache, v_cache, cache_len, plan=None,
                     return_lse: bool = False):
    """Kernel on CUDA tensors, plain version on CPU tensors. ``plan``
    overrides ``split_plan``'s ``(nsplit, chunk)`` (for measuring the
    kernel); the plain version ignores it. With ``return_lse`` the result
    is ``(out, lse)``."""
    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    _check(q, k_cache, v_cache)
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    lens = _lens_tensor(cache_len, b, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    nsplit, chunk = plan or split_plan(b, hq, hkv, smax,
                                       _sm_count(_index(q.device)))
    part = counters = None
    if nsplit > 1:
        part = torch.empty(b * hq * nsplit * (d + 2), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, b * hq)
    lib = build.load()
    with build.on_device(q.device):
        code = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, smax, hq, hkv, d, nsplit, chunk,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, code, "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
