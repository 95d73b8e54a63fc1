"""Oracles for the attention kernels (delegate to the single sources)."""
from __future__ import annotations


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """O(S^2) attention; k/v already at the query head count."""
    from repro_torch.models.layers import attention_reference
    return attention_reference(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention_ref(q, k_cache, v_cache, cache_len):
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k_cache, v_cache, cache_len)
