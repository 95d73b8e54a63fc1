"""Distributed flash-decode over a sequence-sharded KV cache.

Counterpart of ``repro.models.distributed_attention``. When a model's KV
heads are too few to shard over the model axis, its decode cache is sharded
along the *sequence*: rank ``r`` of the model axis holds positions
``[r * s_loc, (r + 1) * s_loc)`` of every row. Gathering that cache every
step is what GSPMD's baseline does; this replaces it with the distributed
flash-decode, as the reference's ``shard_map`` does. The same merge serves
Zamba2's batch-1 cache (the reference's ``long_500k`` layout), whose
sequence is split over the *data* axes while its heads are split over the
model axis: there ``q`` already holds the heads of the rank's cache and is
not gathered. The sequence-split axes are ``seq_axes``:

  * the new token's K/V is written by the rank that owns position
    ``cache_len`` only: a predicated write on the device (the owner's slot
    gets the new row, every other rank rewrites the row it already has),
    so ``cache_len`` is never read by the host;
  * ``q`` arrives as the rank's local heads (the output of a column-split
    ``wq``) and is all-gathered over ``seq_axes`` to all ``Hq`` heads (the
    padding heads of a padded split dropped), the reference's
    ``P(bspec, None, None, None)`` in-spec; with ``gather_q=False`` it is
    used as it is;
  * every rank runs the flash-decode kernel (K1) over its slice with the
    local length ``clamp(cache_len + 1 - r * s_loc, 0, s_loc)`` and takes
    back the rows' log-sum-exp beside the output;
  * the partials merge over ``seq_axes`` with two small all-reduces of
    ``O(B * Hq * D)``:
    ``M = pmax(lse)``, then ``o = psum(exp(lse - M) * o) /
    psum(exp(lse - M))``, which equals the reference's ``pmax``/``psum`` of
    ``(m, l, acc)``. A rank whose slice is empty has ``lse = -inf`` and
    weight 0, as the reference's ``corr = exp(-1e30 - m_glob) = 0``; rank 0
    is never empty.

The merge runs in fp32 on the kernel's outputs, which are in the cache's
dtype: in bf16 each partial is rounded once before the merge, where the
reference merges its fp32 accumulators.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import sharding as S


def write_owned(cache, new, pos, start: int) -> None:
    """Write ``new`` (B, 1, H, D) at the global positions ``pos`` ((1,) or
    (B,)) into ``cache`` (B, s_loc, H, D), which holds positions
    ``[start, start + s_loc)``: a row whose position is not this rank's
    rewrites the row it has. On the device; ``pos`` is never read back."""
    b, s_loc = cache.shape[:2]
    pos = pos.to(torch.long).expand(b)
    li = torch.clamp(pos - start, 0, s_loc - 1)
    own = (pos >= start) & (pos < start + s_loc)
    rows = torch.arange(b, device=cache.device)
    old = cache[rows, li]                                     # (B, H, D)
    cache.index_put_((rows, li), torch.where(own[:, None, None], new[:, 0],
                                             old))


def decode_attention_seq_sharded(q, k_cache, v_cache, k_new, v_new,
                                 cache_len, *, seq_axes, impl: str = "kernel",
                                 mesh=None, gather_q: bool = True,
                                 n_heads=None):
    """q: (B, 1, Hq / n, D), this rank's heads; caches: (B, s_loc, Hkv, D),
    this rank's slice of the sequence (split over ``seq_axes``), written in
    place; k_new / v_new: (B, 1, Hkv, D); cache_len: a 0-d tensor. Returns
    the attention output (B, 1, Hq, D) of every head (the first
    ``n_heads`` of the gathered ones), the same on every rank of
    ``seq_axes``; with ``gather_q=False``, of ``q``'s heads."""
    mesh = mesh if mesh is not None else S.get_mesh()
    s_loc = k_cache.shape[1]
    start = mesh.index(seq_axes) * s_loc
    clen = cache_len.reshape(1).to(torch.long)
    # -- predicated cache write (the owner rank writes the new token) ------
    write_owned(k_cache, k_new, clen, start)
    write_owned(v_cache, v_new, clen, start)
    # -- every head, this rank's slice: K1 with the rows' log-sum-exp ------
    q_all = S.all_gather(q, seq_axes, dim=2, mesh=mesh) if gather_q else q
    if n_heads is not None:
        q_all = q_all[:, :, :n_heads]
    local_len = torch.clamp(clen + 1 - start, 0, s_loc).to(torch.int32)
    o, lse = ops.decode_attention(q_all.contiguous(), k_cache, v_cache,
                                  local_len, impl=impl, return_lse=True)
    # -- merge the partials over the model axis ----------------------------
    m = S.pmax(lse, seq_axes, mesh)
    w = torch.exp(lse - m)                                    # (B, Hq)
    num = S.psum(o.float() * w[:, None, :, None], seq_axes, mesh)
    den = S.psum(w, seq_axes, mesh)
    return (num / den[:, None, :, None]).to(q.dtype)
