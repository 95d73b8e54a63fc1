"""Operations, bytes and the card's peaks: the arithmetic of the
roofline and utilisation metrics.

The peaks are NVIDIA's data sheet for one H100 SXM (dense rates, 700 W).
``bound`` and ``decode_cost`` are frozen copies of
``benchmarks/torch_kernel_bench.py`` (as of the benchmark's first
version), ``wkv6_decode_cost`` one as of the kernel's first version;
``bound`` takes the peaks from this table instead of
``repro_torch.launch.roofline``.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}
FAMILIES = ("dense", "ssm")     # the families ``token_flops`` counts


def bound(nbytes, flops, dtype) -> dict:
    """The least time the card could take: the bytes over HBM's rate or
    the operations over the peak rate of ``dtype``, whichever is larger
    (copied from benchmarks/torch_kernel_bench.py)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def decode_cost(B, Smax, Hq, Hkv, D, lens, item):
    """K1's bytes (the live K and V rows, q in, out, the lengths) and
    operations (q k and p v over the live rows); copied from
    benchmarks/torch_kernel_bench.py."""
    live = sum(min(max(int(n), 0), Smax) for n in lens)
    return ((2 * live * Hkv * D + 2 * B * Hq * D) * item + 4 * B,
            4.0 * live * Hq * D)


def wkv6_decode_cost(B, H, dk, dv, item, live=None):
    """The WKV6 decode step's bytes (r, k, v in, w, u, the state of the
    ``live`` rows read, every row's state written, y, the lengths) and its
    fp32 operations (the readout r S, the update w S + k v, the bonus);
    ``live`` (default: every row) is the rows whose length is not 0.
    Copied from benchmarks/torch_kernel_bench.py."""
    live = B if live is None else live
    nbytes = (B * H * (2 * dk + dv) * item          # r, k, v
              + B * H * dk * 4 + H * dk * 4         # w, u
              + (live + B) * H * dk * dv * 4        # state read, written
              + B * H * dv * 4 + B * 4)             # y, lengths
    return nbytes, float(B * H * (5 * dk * dv + 3 * dk + 2 * dv))


def token_flops(spec: dict, family: str, positions: int) -> float:
    """Model operations (a multiply-add counts 2) of one decoded token that
    attends over ``positions`` positions: every weight matrix it passes
    through, the head, and the attention or the recurrence."""
    n_l, d, v = spec["num_hidden_layers"], spec["hidden_size"], \
        spec["vocab_size"]
    f = spec["intermediate_size"]
    if family == "dense":
        hq, hkv, hd = spec["num_attention_heads"], \
            spec["num_key_value_heads"], spec["head_dim"]
        mats = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f
        mixer = 4 * hq * hd * positions          # q k and p v
    elif family == "ssm":
        hd = spec["head_size"]
        mats = 6 * d * d + 2 * d * 64 + 2 * d * f
        # y = r (S + u k v) and S <- w S + k v: about 6 per state entry
        mixer = 6 * (d // hd) * hd * hd
    else:
        raise ValueError(f"no operation count for family {family!r}")
    return float(n_l * (2 * mats + mixer) + 2 * d * v)
