"""Kernel microbenchmarks of the PyTorch/CUDA port: the chunk-parallel
matmul forms against the naive recurrences, and blocked against reference
attention (the rows of ``benchmarks/kernel_bench.py``, same shapes, same
names), and on CUDA the hand-written kernels alone.

    python3 benchmarks/torch_kernel_bench.py --device cpu     # the six rows
    python3 benchmarks/torch_kernel_bench.py --full           # the card: + kernels

The six rows measure the algorithmic win of the chunked forms (O(S·C·d)
matmuls against S sequential steps). Their inputs are drawn from a numpy
seed; on the CPU they are timed on the host's clock, on CUDA with events
after a synchronise. With ``--full`` (``quick=False``) on CUDA a row is
added for each kernel of ``repro_torch.kernels.ops`` at its main path's
shape (PERF.md §6; the decode step's three fused passes at smollm-360m's
step): its device µs (its calls replayed from a CUDA graph
between two events), its plain version's, the library call's (SDPA for
the attention kernels, ``torch._grouped_mm`` for the grouped GEMM and,
with the epilogue, the fused gate/up pass; none computes WKV6 or the SSD
scan) and the least time the card could take (the bytes it must move over
HBM's rate or its operations over the peak rate, whichever is larger).
Each main case (its shape, its inputs drawn on the card from a
``torch.Generator`` seed, its library call, its bound) is defined here
once: ``chip_smoke.py``'s kernels phase checks and times the same cases
and is the gate of correctness; this bench times.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):       # `python benchmarks/torch_kernel_bench.py`
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _root)                        # the benchmarks package
    sys.path.insert(0, os.path.join(_root, "src"))   # repro_torch itself

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.compat import resolve_device  # noqa: E402
from repro_torch.kernels.chunked import ssd_chunked, wkv6_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ref import ssd_ref, wkv6_ref  # noqa: E402
from repro_torch.models.layers import attention_reference  # noqa: E402

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, n=3, device=torch.device("cpu"), **kw):
    """Seconds of one call after one warm-up call: the host's clock on the
    CPU, CUDA events around the calls after a synchronise on CUDA."""
    fn(*args, **kw)
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args, **kw)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args, **kw)
    return (time.perf_counter() - t0) / n


def wkv6_inputs(device, B=2, S=1024, H=4, dk=32, seed=0):
    """kernel_bench.py's distributions, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    r, k, v = (n(B, S, H, dk) * 0.5 for _ in range(3))
    w = torch.clamp(torch.exp(-torch.exp(n(B, S, H, dk) * 0.5 - 1.5)),
                    0.62, 0.9999)
    u = n(H, dk) * 0.3
    return r, k, v, w, u


def ssd_inputs(device, B=2, S=1024, H=4, N=32, P=32, seed=1):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    x = n(B, S, H, P) * 0.5
    dt = F.softplus(n(B, S, H)) * 0.5
    A = -torch.exp(n(H) * 0.3)
    Bm = n(B, S, H, N) * 0.5
    Cm = n(B, S, H, N) * 0.5
    D = n(H) * 0.3
    return x, dt, A, Bm, Cm, D


def attention_inputs(device, S=2048, seed=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((1, S, 4, 64)).astype(
        np.float32)).to(device) for _ in range(3))


def run(reporter, quick: bool = True, device=None) -> dict:
    """The reference's six rows on ``device`` (None: the GPU); with
    ``quick=False`` on CUDA, the kernel rows after them."""
    device = resolve_device(device)
    out = {}
    with torch.inference_mode():
        args = wkv6_inputs(device)
        S = args[0].shape[1]
        t_ref = _time(lambda *a: wkv6_ref(*a)[0], *args, device=device)
        t_chk = _time(lambda *a: wkv6_chunked(*a, chunk=64)[0], *args,
                      device=device)
        reporter.add("kernels/wkv6-naive-scan", t_ref * 1e6, f"S={S}")
        reporter.add("kernels/wkv6-chunked", t_chk * 1e6,
                     f"speedup={t_ref / t_chk:.1f}x")
        out["wkv6_speedup"] = t_ref / t_chk

        args = ssd_inputs(device)
        t_ref = _time(lambda *a: ssd_ref(*a)[0], *args, device=device)
        t_chk = _time(lambda *a: ssd_chunked(*a, chunk=64)[0], *args,
                      device=device)
        reporter.add("kernels/ssd-naive-scan", t_ref * 1e6, f"S={S}")
        reporter.add("kernels/ssd-chunked", t_chk * 1e6,
                     f"speedup={t_ref / t_chk:.1f}x")
        out["ssd_speedup"] = t_ref / t_chk

        # blocked attention vs O(S^2)-materializing reference
        q, kk, vv = attention_inputs(device)
        S2 = q.shape[1]
        t_ref = _time(lambda *a: attention_reference(*a, causal=True),
                      q, kk, vv, device=device)
        t_fla = _time(lambda *a: flash_attention_plain(
            *a, causal=True, q_chunk=256, kv_chunk=256), q, kk, vv,
            device=device)
        reporter.add("kernels/attention-reference", t_ref * 1e6, f"S={S2}")
        reporter.add("kernels/attention-blocked", t_fla * 1e6,
                     f"ratio={t_ref / t_fla:.2f}x")
    if device.type == "cuda" and not quick:
        out["kernels"] = cuda_kernels(reporter, device)
    return out


# -- the kernels' main cases: shapes, inputs, library calls, bounds --------------
#
# One definition of each, shared with chip_smoke.py: its kernels phase
# checks every kernel at these shapes on these inputs (beside its other
# cases) and times it, this bench times the kernels alone. Inputs are drawn
# on the card from a ``torch.Generator`` seed (the grouped GEMM's weights
# are 9 GB a matrix).

SEED = 1234
FLASH_CALLS = 8      # K2 calls per timed CUDA graph
RAGGED = [1, 1024, 37, 512, 700, 64, 999, 250]   # K1's per-slot lengths
DECODE_LAYERS = 32   # K1's distinct caches a timed graph walks


def moe_group_sizes(T, k, E, seed):
    """The group sizes a router's top-k gives T tokens over E experts (each
    token picks k distinct experts; uniform draws from the seed)."""
    rng = np.random.default_rng(seed)
    sizes = np.zeros(E, np.int64)
    for _ in range(T):
        sizes[rng.choice(E, k, replace=False)] += 1
    return sizes.tolist()


# PERF.md §6's main path of each kernel: K1 at one ContinuousBatcher step of
# smollm-360m (8 slots, a 1024-long cache, ragged lengths), K2 at its
# 256-token causal prefill, K3 at rwkv6-7b's forward (the 256-token prompt,
# zero initial state), K4 at zamba2-2.7b's (B and C broadcast over the
# heads, fp32 as the model passes them, zero initial state), the grouped
# GEMM and the fused gate/up pass at arctic-480b's decode gate (16 rows
# over 128 experts: 8 slots, top-2), the WKV6 decode step at rwkv6-7b's
# captured step (64 slots, 64 heads of 64, every row continuing)
MAIN = {
    "decode_attention": dict(B=8, Smax=1024, Hq=15, Hkv=5, D=64,
                             dtype=torch.bfloat16, lens=RAGGED),
    "flash_attention": dict(B=1, Sq=256, Skv=256, Hq=15, Hkv=5, D=64,
                            dtype=torch.bfloat16, causal=True),
    "wkv6": dict(B=1, S=256, H=64, dk=64, dv=64, chunk=64,
                 dtype=torch.bfloat16),
    "ssd": dict(b=1, S=256, H=80, P=64, N=64, chunk=64, dtype=torch.float32,
                broadcast=True),
    "grouped_matmul": dict(C=16, K=7168, N=4864, E=128,
                           sizes=moe_group_sizes(8, 2, 128, SEED),
                           dtype=torch.bfloat16),
}
MAIN["grouped_swiglu"] = dict(MAIN["grouped_matmul"], fused=True)
MAIN["wkv6_decode"] = dict(B=64, H=64, dk=64, dv=64, dtype=torch.bfloat16)
# the fused passes of DecoderLM's decode step at smollm-360m's captured step
# (64 slots: d 960, 15 / 5 heads of 64 over a 1024-long cache, d_ff 2560)
MAIN["add_rms_norm"] = dict(B=64, d=960, dtype=torch.bfloat16)
MAIN["rope_kv_write"] = dict(B=64, Smax=1024, Hq=15, Hkv=5, D=64,
                             dtype=torch.bfloat16)
MAIN["silu_mul"] = dict(B=64, d_ff=2560, dtype=torch.bfloat16)


def time_ms(fn, n_inner: int = 1, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one call inside ``fn`` (``fn`` makes ``n_inner``
    calls), measured with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_inner)


def device_ms(fn, n_inner: int = 1, reps: int = 20) -> float:
    """Mean milliseconds of device time of one call inside ``fn``: the calls
    are captured once into a CUDA graph and the graph is replayed, so the
    host's launch path (Python, the allocator, the launch call) is left out
    and what is timed is the kernels alone, back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, n_inner, reps=reps, warmup=2)


def bound(nbytes, flops, dtype) -> dict:
    """The least time the card could take: the bytes over HBM's rate or
    the operations over the peak rate of ``dtype``, whichever is larger
    (the H100 SXM data sheet's peaks, ``launch/roofline.py``)."""
    from repro_torch.launch import roofline

    by_bytes = nbytes / roofline.HBM_BW * 1e3
    by_ops = flops / roofline.peak_flops(str(dtype)) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def decode_cost(B, Smax, Hq, Hkv, D, lens, item):
    """K1's bytes (the live K and V rows, q in, out, the lengths) and
    operations (q k and p v over the live rows)."""
    live = sum(min(max(int(n), 0), Smax) for n in lens)
    return ((2 * live * Hkv * D + 2 * B * Hq * D) * item + 4 * B,
            4.0 * live * Hq * D)


def visible_pairs(Sq, Skv, causal, q_offset) -> int:
    if not causal:
        return Sq * Skv
    return sum(min(Skv, i + q_offset + 1) for i in range(Sq))


def flash_cost(B, Sq, Skv, Hq, Hkv, D, causal, q_offset, item):
    """K2's bytes (q in, out, k, v) and operations over the visible
    pairs."""
    return ((2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * item,
            4.0 * D * Hq * B * visible_pairs(Sq, Skv, causal, q_offset))


def wkv6_cost(B, S, H, dk, dv, chunk, item):
    """K3's bytes, operations, and the products among them (what runs on
    the tensor cores)."""
    n_chunks = S // chunk
    nbytes = (B * S * H * (2 * dk + dv) * item     # r, k, v
              + B * S * H * dk * 4 + H * dk * 4     # w, u
              + 2 * B * H * dk * dv * 4             # state in and out
              + B * S * H * dv * 4)                 # y
    products = (2 * dk * chunk * (chunk - 1) // 2   # strictly-lower scores
                + 2 * dv * chunk * (chunk + 1) // 2  # scores @ v
                + 4 * chunk * dk * dv)               # q_dec @ S, carry
    per_chunk = (products
                 + 2 * dk * chunk                   # the u bonus
                 + dk * dv)                         # the state's decay
    return (nbytes, float(B * H * n_chunks * per_chunk),
            float(B * H * n_chunks * products))


def wkv6_decode_cost(B, H, dk, dv, item, live=None):
    """The WKV6 decode step's bytes (r, k, v in, w, u, the state of the
    ``live`` rows read, every row's state written, y, the lengths) and its
    fp32 operations (the readout r S, the update w S + k v, the bonus);
    ``live`` (default: every row) is the rows whose length is not 0."""
    live = B if live is None else live
    nbytes = (B * H * (2 * dk + dv) * item          # r, k, v
              + B * H * dk * 4 + H * dk * 4         # w, u
              + (live + B) * H * dk * dv * 4        # state read, written
              + B * H * dv * 4 + B * 4)             # y, lengths
    return nbytes, float(B * H * (5 * dk * dv + 3 * dk + 2 * dv))


def add_rms_norm_cost(B, d, item, delta=True):
    """The residual add and norm's bytes (x and delta read, the residual
    and the norm's output written, the weight) and operations (the add,
    the sum of squares, two products a value)."""
    n = B * d
    return (4 if delta else 2) * n * item + d * 4, float(n * (4 if delta
                                                              else 3))


def rope_kv_write_cost(B, Hq, Hkv, D, item):
    """The rotation and cache write's bytes (q read and written, k and v
    read and written into the cache, the tables, the positions) and
    operations (four products and two sums a pair)."""
    return ((2 * B * Hq * D + 4 * B * Hkv * D) * item + B * D * 4 + B * 8,
            3.0 * B * (Hq + Hkv) * D)


def silu_mul_cost(B, d_ff, item):
    """silu(g) * u's bytes (g and u read, the product written) and
    operations (negation, exp, add, divide, product a value)."""
    return 3 * B * d_ff * item, 5.0 * B * d_ff


def ssd_cost(b, S, H, P, N, chunk, item, broadcast):
    """K4's bytes, operations, and the products among them."""
    n_chunks = S // chunk
    bc_bytes = 2 * b * S * N * item * (1 if broadcast else H)
    nbytes = (b * S * H * P * item + b * S * H * 4 + 2 * H * 4 + bc_bytes
              + 2 * b * H * P * N * 4 + b * S * H * P * 4)
    pairs = chunk * (chunk + 1) // 2                # j <= i
    # C_i . B_j does not depend on the head when B and C are shared
    scores = 2 * N * pairs * (1 if broadcast else H)
    products = scores + H * (2 * P * pairs          # scores @ (x dt)
                             + 4 * chunk * P * N)   # C h^T, carry
    flops = float(b * n_chunks * (products + H * (
        pairs                                       # the decays
        + 3 * chunk * P)))                          # x dt, D x
    return nbytes, flops, float(b * n_chunks * products)


def grouped_cost(C, K, N, E, sizes, n_mats, item):
    """The grouped GEMM's bytes (the active experts' weights, x, out, the
    sizes) and operations over the rows in groups."""
    active, rows = sum(1 for n in sizes if n), int(sum(sizes))
    return ((n_mats * active * K * N + C * K + C * N) * item + E * 8,
            2.0 * n_mats * rows * K * N)


def decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens, n_layers, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((n_layers, B, 1, Hq, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    kc = torch.randn((n_layers, B, Smax, Hkv, D), generator=g, device="cuda",
                     dtype=torch.float32).to(dtype)
    vc = torch.randn((n_layers, B, Smax, Hkv, D), generator=g, device="cuda",
                     dtype=torch.float32).to(dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kc, vc, lens_t


def flash_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    return q, k, v


def wkv6_card_inputs(B, S, H, dk, dv, dtype, seed, strong_decay=False):
    """The distributions of tests/test_kernels.py, drawn on the card. With
    ``strong_decay`` every log w sits at the models' clamp (-0.5), so that
    over a chunk of 64 the factors exp(+-cum) reach e^32, where the 3xTF32
    split's error is largest."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (n(B, S, H, d) * 0.5 for d in (dk, dk, dv))
    w = torch.exp(-torch.exp(n(B, S, H, dk) * 0.5 - 1.5)).clamp(0.62, 0.9999)
    if strong_decay:
        w = torch.full_like(w, math.exp(-0.5))
    u = n(H, dk) * 0.3
    s0 = n(B, H, dk, dv) * 0.1
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


def wkv6_decode_inputs(B, H, dk, dv, dtype, n_layers, seed):
    """One token of ``wkv6_card_inputs`` and a cache of ``n_layers`` states
    (n_layers, B, H, dk, dv) drawn as its s0, every row continuing
    (lengths 1 to B)."""
    r, k, v, w, u, _ = wkv6_card_inputs(B, 1, H, dk, dv, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    states = torch.randn((n_layers, B, H, dk, dv), generator=g,
                         device="cuda") * 0.1
    lens = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
    return r, k, v, w, u, states, lens


def norm_inputs(B, d, dtype, seed):
    """x and delta (B, 1, d) of standard deviation 2, the weight 1 + N(0,
    0.3) in fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, delta = (torch.randn((B, 1, d), generator=g, device="cuda").mul_(
        2.0).to(dtype) for _ in range(2))
    w = torch.randn((d,), generator=g, device="cuda").mul_(0.3).add_(1.0)
    return x, delta, w


def rope_inputs(B, Smax, Hq, Hkv, D, dtype, seed, lens=None, mrope=None):
    """q (B,1,Hq,D), k and v (B,1,Hkv,D), the layer's caches (B,Smax,Hkv,D),
    the write positions (default: spread over the cache, a row at 0 and
    one at its end) as int64 and their rotary tables (M-RoPE's with
    ``mrope`` sections)."""
    from repro_torch.models import layers as L

    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = n(B, 1, Hq, D), n(B, 1, Hkv, D), n(B, 1, Hkv, D)
    ck, cv = n(B, Smax, Hkv, D), n(B, Smax, Hkv, D)
    if lens is None:
        lens = [i * (Smax - 1) // max(B - 1, 1) for i in range(B)]
    pos = torch.tensor(lens, dtype=torch.int64, device="cuda")
    if mrope is None:
        cos, sin = L.rope_tables(pos[:, None], D)
    else:
        p = pos[:, None]
        cos, sin = L.mrope_tables(torch.stack([p, p, p], -1), D, mrope)
    return q, k, v, cos, sin, ck, cv, pos


def silu_inputs(B, d_ff, dtype, seed):
    """g (B, 1, d_ff) of standard deviation 3 and u of 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gate = torch.randn((B, 1, d_ff), generator=g, device="cuda").mul_(3.0)
    up = torch.randn((B, 1, d_ff), generator=g, device="cuda")
    return gate.to(dtype), up.to(dtype)


def ssd_card_inputs(b, S, H, P, N, dtype, broadcast, seed, init_scale=False):
    """The distributions of tests/test_kernels.py; with ``broadcast`` B and
    C are one (b, S, N) tensor viewed over the heads (head stride 0) and x
    a strided view, as Zamba2Model passes them. ``init_scale`` draws what
    zamba2-2.7b's mixers see under the reference's init instead: in_proj
    outputs of std ~17 (fan-in n_super = 9 over d_model 2560), so dt =
    softplus(N(0, 17)) and x, B, C = silu of their width-4 conv (std ~6.8),
    with A = -linspace(1, 8, H)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    if init_scale:
        dt = F.softplus(n(b, S, H) * 17.0)
        A = -torch.linspace(1.0, 8.0, H, device="cuda")

        def act(*shape):
            return F.silu(n(*shape) * 6.8)
    else:
        dt = F.softplus(n(b, S, H) * 0.5) * 0.5
        A = -torch.exp(n(H) * 0.3)

        def act(*shape):
            return n(*shape) * 0.5
    D = n(H) * 0.3
    h0 = n(b, H, P, N) * 0.1
    if broadcast:
        x = act(b, S, H * P + 2 * N).to(dtype)[..., :H * P].reshape(
            b, S, H, P)
        bc = act(b, S, 2 * N).to(dtype)
        Bm = bc[..., :N][:, :, None, :].expand(b, S, H, N)
        Cm = bc[..., N:][:, :, None, :].expand(b, S, H, N)
    else:
        x = act(b, S, H, P).to(dtype)
        Bm, Cm = (act(b, S, H, N).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, D, h0


def grouped_inputs(C, K, N, E, dtype, fused, seed):
    """x and the expert weights (two with ``fused``: gate and up), scaled
    by K^-1/2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((C, K), generator=g, device="cuda", dtype=dtype)
    ws = [torch.randn((E, K, N), generator=g, device="cuda",
                      dtype=dtype).mul_(K ** -0.5)
          for _ in range(2 if fused else 1)]
    return x, ws


def sdpa_decode(q, kc, vc, mask):
    """K1's library yardstick, used nowhere in the port."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def sdpa_prefill(q, k, v, causal):
    """K2's library yardstick (its causal mask aligned top-left, so the
    same function only when non-causal or square), used nowhere in the
    port."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def grouped_library(x, w, gs):
    """``torch._grouped_mm`` on the same rows (bf16, offsets on the
    device): the library yardstick, used nowhere in the port."""
    return torch._grouped_mm(x, w, offs=torch.cumsum(gs, 0,
                                                     dtype=torch.int32))


def swiglu_library(x, wg, wu, gs):
    """The fused pass's yardstick: ``torch._grouped_mm`` twice and the
    epilogue, used nowhere in the port."""
    g, u = grouped_library(x, wg, gs), grouped_library(x, wu, gs)
    return (F.silu(g.float()) * u.float()).to(x.dtype)


# -- the CUDA leg: each main case timed alone --------------------------------------

def _calls(fn, n):
    def run():
        for _ in range(n):
            fn()
    return run


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _timed(kern, plain, library, n_inner=1, plain_eager=False):
    """Device ms of the kernel, its plain version and the library call
    (None: there is none). A plain version that reads the device on the
    host cannot be captured: it is timed from Python."""
    return {"ms": device_ms(kern, n_inner),
            "plain_ms": time_ms(plain, n_inner, reps=5, warmup=1)
            if plain_eager else device_ms(plain, n_inner, reps=5),
            "library_ms": None if library is None
            else device_ms(library, n_inner)}


def bench_decode():
    from repro_torch.kernels import ops

    s, L = MAIN["decode_attention"], DECODE_LAYERS
    q, kc, vc, lens = decode_inputs(**s, n_layers=L, seed=SEED)
    mask = (torch.arange(s["Smax"], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def each(fn):
        return lambda: [fn(i) for i in range(L)]

    return {"max_abs_err": _err(
                ops.decode_attention(q[0], kc[0], vc[0], lens),
                ops.decode_attention(q[0], kc[0], vc[0], lens,
                                     impl="plain")),
            **_timed(each(lambda i: ops.decode_attention(
                         q[i], kc[i], vc[i], lens)),
                     each(lambda i: ops.decode_attention(
                         q[i], kc[i], vc[i], lens, impl="plain")),
                     each(lambda i: sdpa_decode(q[i], kc[i], vc[i], mask)),
                     L),
            "library": "SDPA",
            **bound(*decode_cost(s["B"], s["Smax"], s["Hq"], s["Hkv"],
                                 s["D"], s["lens"], q.element_size()),
                    s["dtype"])}


def bench_flash():
    from repro_torch.kernels import ops

    s = MAIN["flash_attention"]
    q, k, v = flash_inputs(**{n: s[n] for n in (
        "B", "Sq", "Skv", "Hq", "Hkv", "D", "dtype")}, seed=SEED + 1)

    def kern():
        return ops.flash_attention(q, k, v, causal=s["causal"])

    def plain():
        return ops.flash_attention(q, k, v, causal=s["causal"],
                                   impl="plain")

    return {"max_abs_err": _err(kern(), plain()),
            **_timed(_calls(kern, FLASH_CALLS), _calls(plain, FLASH_CALLS),
                     _calls(lambda: sdpa_prefill(q, k, v, s["causal"]),
                            FLASH_CALLS), FLASH_CALLS),
            "library": "SDPA",
            **bound(*flash_cost(s["B"], s["Sq"], s["Skv"], s["Hq"], s["Hkv"],
                                s["D"], s["causal"], 0, q.element_size()),
                    s["dtype"])}


def bench_wkv6():
    from repro_torch.kernels import ops

    s = MAIN["wkv6"]
    r, k, v, w, u, s0 = wkv6_card_inputs(
        s["B"], s["S"], s["H"], s["dk"], s["dv"], s["dtype"], SEED + 3)
    s0 = torch.zeros_like(s0)

    def kern():
        return ops.wkv6(r, k, v, w, u, s0, chunk=s["chunk"])

    def plain():
        return ops.wkv6(r, k, v, w, u, s0, chunk=s["chunk"], impl="plain")

    nbytes, flops, _ = wkv6_cost(s["B"], s["S"], s["H"], s["dk"], s["dv"],
                                 s["chunk"], r.element_size())
    return {"max_abs_err": _err(kern()[0], plain()[0]),
            **_timed(kern, plain, None),
            "library": "none: no PyTorch call computes WKV6",
            **bound(nbytes, flops, s["dtype"])}


def bench_wkv6_decode():
    """One launch a layer on that layer's slice of a 32-layer cache (each
    launch finds its state out of L2, as in rwkv6-7b's step), in place;
    ``step_ms`` is the 32 launches of a step. The plain form is
    ``chunked.wkv6_decode`` with the rows' keep and the copy back."""
    from repro_torch.kernels import ops

    s, L = MAIN["wkv6_decode"], DECODE_LAYERS
    r, k, v, w, u, states, lens = wkv6_decode_inputs(**s, n_layers=L,
                                                     seed=SEED + 5)
    got, want = states[0].clone(), states[0].clone()
    err = _err(ops.wkv6_decode(r, k, v, w, u, got, lens),
               ops.wkv6_decode(r, k, v, w, u, want, lens, impl="plain"))

    def each(impl):
        return lambda: [ops.wkv6_decode(r, k, v, w, u, states[i], lens,
                                        impl=impl) for i in range(L)]

    rec = {"max_abs_err": max(err, _err(got, want)),
           **_timed(each("kernel"), each("plain"), None, L),
           "library": "none: no PyTorch call computes WKV6",
           **bound(*wkv6_decode_cost(s["B"], s["H"], s["dk"], s["dv"],
                                     r.element_size()), torch.float32)}
    rec.update(layers=L, step_ms=rec["ms"] * L,
               plain_step_ms=rec["plain_ms"] * L,
               bound_step_ms=rec["bound_ms"] * L)
    del states
    torch.cuda.empty_cache()
    return rec


def bench_ssd():
    from repro_torch.kernels import ops

    s = MAIN["ssd"]
    x, dt, A, Bm, Cm, D, h0 = ssd_card_inputs(
        s["b"], s["S"], s["H"], s["P"], s["N"], s["dtype"], s["broadcast"],
        SEED + 4)
    h0 = torch.zeros_like(h0)

    def kern():
        return ops.ssd(x, dt, A, Bm, Cm, D, h0, chunk=s["chunk"])

    def plain():
        return ops.ssd(x, dt, A, Bm, Cm, D, h0, chunk=s["chunk"],
                       impl="plain")

    nbytes, flops, _ = ssd_cost(s["b"], s["S"], s["H"], s["P"], s["N"],
                                s["chunk"], x.element_size(), s["broadcast"])
    return {"max_abs_err": _err(kern()[0], plain()[0]),
            **_timed(kern, plain, None),
            "library": "none: no PyTorch call computes the SSD scan",
            **bound(nbytes, flops, s["dtype"])}


def bench_grouped(name):
    """Its plain version reads the group sizes on the host, so it is timed
    from Python (not capturable)."""
    from repro_torch.kernels import ops

    s = MAIN[name]
    fused = s.get("fused", False)
    x, ws = grouped_inputs(s["C"], s["K"], s["N"], s["E"], s["dtype"], fused,
                           SEED + 11)
    gs = torch.tensor(s["sizes"], dtype=torch.int64, device="cuda")
    op = ops.grouped_swiglu if fused else ops.grouped_matmul
    lib = swiglu_library if fused else grouped_library
    has_lib = hasattr(torch, "_grouped_mm")
    rec = {"max_abs_err": _err(op(x, *ws, gs), op(x, *ws, gs, impl="plain")),
           "active_experts": sum(1 for n in s["sizes"] if n),
           **_timed(lambda: op(x, *ws, gs),
                    lambda: op(x, *ws, gs, impl="plain"),
                    (lambda: lib(x, *ws, gs)) if has_lib else None,
                    plain_eager=True),
           "library": ("2 x torch._grouped_mm + silu" if fused
                       else "torch._grouped_mm") if has_lib
           else "none: this torch has no torch._grouped_mm",
           **bound(*grouped_cost(s["C"], s["K"], s["N"], s["E"], s["sizes"],
                                 len(ws), x.element_size()), s["dtype"])}
    del x, ws
    torch.cuda.empty_cache()
    return rec


def bench_fused(name):
    """One of the decode step's fused passes at smollm-360m's step (64
    slots), 32 calls a timed graph (one a layer; the norm runs 65 a step);
    its plain form is the composition it replaces."""
    from repro_torch.kernels import ops

    s, L = MAIN[name], DECODE_LAYERS
    if name == "add_rms_norm":
        x, delta, w = norm_inputs(s["B"], s["d"], s["dtype"], SEED + 21)

        def call(impl):
            return ops.add_rms_norm(x, delta, w, impl=impl)[1]

        cost = add_rms_norm_cost(s["B"], s["d"], x.element_size())
    elif name == "rope_kv_write":
        q, k, v, cos, sin, ck, cv, pos = rope_inputs(
            **{n: s[n] for n in ("B", "Smax", "Hq", "Hkv", "D", "dtype")},
            seed=SEED + 22)

        def call(impl):
            return ops.rope_kv_write(q, k, v, cos, sin, ck, cv, pos,
                                     impl=impl)

        cost = rope_kv_write_cost(s["B"], s["Hq"], s["Hkv"], s["D"],
                                  q.element_size())
    else:
        gate, up = silu_inputs(s["B"], s["d_ff"], s["dtype"], SEED + 23)

        def call(impl):
            return ops.silu_mul(gate, up, impl=impl)

        cost = silu_mul_cost(s["B"], s["d_ff"], gate.element_size())
    rec = {"max_abs_err": _err(call("kernel"), call("plain")),
           **_timed(_calls(lambda: call("kernel"), L),
                    _calls(lambda: call("plain"), L), None, L),
           "library": "none: no one PyTorch call computes the pass",
           **bound(*cost, s["dtype"])}
    rec.update(layers=L)
    return rec


CUDA_ROWS = (("decode_attention", "K1", bench_decode),
             ("flash_attention", "K2", bench_flash),
             ("wkv6", "K3", bench_wkv6),
             ("ssd", "K4", bench_ssd),
             ("grouped_matmul", "B5", lambda: bench_grouped("grouped_matmul")),
             ("grouped_swiglu", "B5f",
              lambda: bench_grouped("grouped_swiglu")),
             ("wkv6_decode", "K3d", bench_wkv6_decode),
             ("add_rms_norm", "F1", lambda: bench_fused("add_rms_norm")),
             ("rope_kv_write", "F2", lambda: bench_fused("rope_kv_write")),
             ("silu_mul", "F3", lambda: bench_fused("silu_mul")))


def cuda_kernels(reporter, device) -> list:
    """One row a kernel at its main case: its device µs, with the plain
    version's, the library call's and the bound in ``derived``. fp32
    products run without TF32, as chip_smoke.py's comparisons do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    with torch.inference_mode(), torch.cuda.device(device):
        for name, tag, fn in CUDA_ROWS:
            shape = {k: v for k, v in MAIN[name].items() if k != "sizes"}
            rec = {"name": name, "id": tag, **fn(),
                   "shape": {k: str(v).replace("torch.", "")
                             if isinstance(v, torch.dtype) else v
                             for k, v in shape.items()}}
            lib = rec["library_ms"]
            reporter.add(
                f"kernels/cuda/{name}", rec["ms"] * 1e3,
                f"plain_us={rec['plain_ms'] * 1e3:.3f};library_us="
                f"{'none' if lib is None else f'{lib * 1e3:.3f}'};"
                f"bound_us={rec['bound_ms'] * 1e3:.3f};"
                f"bound_by={rec['bound_by']}")
            rows.append(rec)
    return rows


def main(argv=None) -> int:
    from benchmarks.torch_common import CsvReporter

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="on CUDA, also time every kernel alone")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; the CPU only when "
                         "asked)")
    ap.add_argument("--out", default=None, help="also write the rows as JSON")
    args = ap.parse_args(argv)
    rep = CsvReporter()
    rep.header()
    out = run(rep, quick=not args.full, device=args.device)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rep.rows, **out}, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
