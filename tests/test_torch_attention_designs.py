"""The arithmetic of the two attention kernels' designs, held on the CPU.

The CUDA kernels cannot run without a GPU, so what is tested here is what
their designs add to the function, written out in plain PyTorch in this
file (not in the package) and held against the port's plain versions and
the JAX package on the same numpy inputs:

  * flash-decode (``csrc/decode_attention.cu``) splits each row's KV range
    over blocks by a host-side plan made from shapes alone
    (``decode_attention.split_plan``) and merges the blocks' partial
    ``(m, l, acc)`` with a max / sum-exp merge; a split past the row's
    length is an empty partial;
  * flash attention (``csrc/flash_attention.cu``) in bf16 runs both
    products on the tensor cores and rounds the probabilities P to bf16
    before P V, the one rounding the fp32 reference does not make.

Tolerances are the reference's own (tests/test_kernels.py): 2e-5 in fp32,
2e-2 in bf16; for bf16 every side rounds the same numpy input.
"""
import inspect
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, heads_per_block, split_plan)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models.layers import NEG_INF, repeat_kv  # noqa: E402
from torch_port_util import as_np, to_jax, to_torch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "kernels", "csrc")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


# -- (a) the host-side split planner ------------------------------------------

PLAN_SHAPES = [   # (B, Hq, Hkv, Smax)
    (8, 15, 5, 1024),       # smollm-360m's batcher step
    (1, 15, 5, 4096),       # one long row
    (1, 32, 32, 1024),      # zamba2-2.7b's shared attention
    (4, 15, 5, 2048),
    (2, 4, 4, 300),         # Smax not a multiple of 32
    (1, 48, 1, 640),        # MQA
    (1, 15, 5, 100),        # shorter than one split
    (1, 15, 5, 65536),      # more splits than the kernel takes, capped
    (64, 15, 5, 1024),      # enough blocks without splitting
    (8, 32, 32, 1024),
]


def _ranges(plan, smax):
    nsplit, chunk = plan
    return [(s * chunk, min((s + 1) * chunk, smax)) for s in range(nsplit)]


@pytest.mark.parametrize("B,Hq,Hkv,Smax", PLAN_SHAPES)
def test_split_plan_covers_the_cache_once(B, Hq, Hkv, Smax):
    plan = split_plan(B, Hq, Hkv, Smax)
    nsplit, chunk = plan
    assert 1 <= nsplit <= K1.MAX_SPLIT
    ranges = _ranges(plan, Smax)
    # contiguous, no overlap, no empty split, exactly [0, Smax)
    assert ranges[0][0] == 0 and ranges[-1][1] == Smax
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    # every split but the last is whole 32-position tiles, one per warp
    assert all((hi - lo) % (32 * K1.WARPS) == 0 for lo, hi in ranges[:-1])


@pytest.mark.parametrize("B,Hq,Hkv", [(64, 15, 5), (132, 4, 1), (8, 32, 32),
                                      (1, 132, 132)])
def test_split_plan_does_not_split_large_batches(B, Hq, Hkv):
    """Once the (row, KV head, head group) blocks alone fill the SMs the
    plan is the single-pass path: one block a group, no scratch."""
    assert split_plan(B, Hq, Hkv, 4096) == (1, 4096)


@pytest.mark.parametrize("B,Hq,Hkv,Smax", [(8, 15, 5, 1024),
                                           (1, 15, 5, 4096),
                                           (1, 32, 32, 1024)])
def test_split_plan_splits_small_batches(B, Hq, Hkv, Smax):
    """Below a block per SM the plan splits, up to ~2 blocks per SM."""
    nsplit, chunk = split_plan(B, Hq, Hkv, Smax)
    units = B * Hkv * (Hq // Hkv // heads_per_block(Hq // Hkv))
    assert nsplit > 1 and units * nsplit <= 4 * K1.SMS


def test_split_plan_takes_no_lengths():
    """The plan is made from shapes alone: a length would have to be read
    back from the card, a sync inside the host-bound decode step."""
    params = list(inspect.signature(split_plan).parameters)
    assert params == ["b", "hq", "hkv", "smax", "sms"]
    src = inspect.getsource(K1.decode_attention)
    assert ".item()" not in src and ".tolist()" not in src
    assert ".cpu()" not in src and "int(lens" not in src


@pytest.mark.parametrize("g", range(1, 17))
def test_heads_per_block_is_the_kernels_rule(g):
    text = open(os.path.join(CSRC, "decode_attention.cu")).read()
    cands = [int(x) for x in re.search(
        r"const int cands\[\] = \{([\d, ]+)\}", text).group(1).split(",")]
    want = next((c for c in cands if g % c == 0), 1)
    assert heads_per_block(g) == want
    for name in ("MAX_SPLIT", "NW"):
        const = int(re.search(rf"constexpr int {name} = (\d+);",
                              text).group(1))
        assert const == {"MAX_SPLIT": K1.MAX_SPLIT, "NW": K1.WARPS}[name]


# -- (b) a model of split-KV flash-decode --------------------------------------

def split_decode_model(q, k_cache, v_cache, lens, plan):
    """What the split kernel computes: every split of every row is an
    online-softmax partial (m, l, acc) over its positions below the row's
    length (empty: m = NEG_INF, l = 0, acc = 0); the partials are merged
    with weights exp(m_s - max m) and the result is acc / max(l, 1e-20).
    fp32 arithmetic on q's values; output in q's dtype."""
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    kf = repeat_kv(k_cache.float(), hq // hkv)           # (B, Smax, Hq, D)
    vf = repeat_kv(v_cache.float(), hq // hkv)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kf) / math.sqrt(d)
    pos = torch.arange(smax)
    ms, ls, accs = [], [], []
    for lo, hi in _ranges(plan, smax):
        live = (pos >= lo) & (pos < hi) & (pos[None, :] < lens[:, None])
        sm = torch.where(live[:, None, :], s, torch.full_like(s, NEG_INF))
        m = sm.max(dim=-1).values                          # (B, Hq)
        p = torch.where(live[:, None, :], torch.exp(sm - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, vf))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    f = torch.exp(m - m.max(dim=0).values)
    out = (acc * f[..., None]).sum(0) / torch.clamp(
        (l * f).sum(0), min=1e-20)[..., None]
    return out[:, None].to(q.dtype)


DECODE_CASES = [   # (B, Smax, Hq, Hkv, D, lens)
    # smollm's heads; lengths 0, 1, below the first boundary (256), Smax
    (4, 512, 15, 5, 64, [0, 1, 100, 512]),
    (4, 512, 15, 5, 64, [256, 257, 383, 7]),
    # zamba2's heads (D = 80), MHA
    (2, 384, 32, 32, 80, [256, 0]),
    # MQA at D = 128, D = 32
    (3, 256, 8, 1, 128, [255, 1, 130]),
    (2, 300, 6, 2, 32, [300, 31]),
]


@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,lens", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_model_vs_plain_and_jnp(B, Smax, Hq, Hkv, D, lens,
                                             dtype):
    """Split-and-merge at the planner's plan and at a fine forced one equals
    the port's plain version and, on rows of non-zero length, JAX's
    ``decode_attention_jnp`` (which averages a zero-length row's cache where
    the Pallas body, the kernel and the plain version give 0)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, kc, vc = (_randn(11, B, 1, Hq, D), _randn(12, B, Smax, Hkv, D),
                 _randn(13, B, Smax, Hkv, D))
    tq, tk, tv = (to_torch(x, tdt) for x in (q, kc, vc))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    plain = decode_attention_plain(tq, tk, tv, lens_t)
    want = JL.decode_attention_jnp(to_jax(q, jdt), to_jax(kc, jdt),
                                   to_jax(vc, jdt), jnp.array(lens, jnp.int32))
    live = np.array(lens) > 0
    plans = {split_plan(B, Hq, Hkv, Smax), (-(-Smax // 32), 32), (1, Smax)}
    assert any(p[0] > 1 for p in plans)
    for plan in plans:
        got = split_decode_model(tq, tk, tv, lens_t, plan)
        assert got.dtype == tdt and got.shape == (B, 1, Hq, D)
        _close(got, plain, tol)
        _close(got[live], as_np(want)[live], tol)
        assert float(got[torch.from_numpy(~live)].float().abs().sum()) == 0


@pytest.mark.parametrize("Smax,clen,bkv", [(512, 100, 128), (512, 512, 256),
                                          (384, 1, 128), (384, 257, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_model_vs_pallas_interpret(Smax, clen, bkv, dtype):
    """Against the Pallas body in interpret mode (one length for the batch,
    as the Pallas wrapper takes), at the planner's split of 15/5 heads."""
    jdt, tdt, tol = DTYPES[dtype]
    B, Hq, Hkv, D = 2, 15, 5, 64
    q, kc, vc = (_randn(21, B, 1, Hq, D), _randn(22, B, Smax, Hkv, D),
                 _randn(23, B, Smax, Hkv, D))
    plan = split_plan(B, Hq, Hkv, Smax)
    assert plan[0] > 1
    want = decode_attention_pallas(to_jax(q, jdt), to_jax(kc, jdt),
                                   to_jax(vc, jdt), jnp.array(clen, jnp.int32),
                                   block_kv=bkv, interpret=True)
    got = split_decode_model(to_torch(q, tdt), to_torch(kc, tdt),
                             to_torch(vc, tdt),
                             torch.full((B,), clen, dtype=torch.int32), plan)
    _close(got, want, tol)


def test_split_decode_model_all_splits_empty_gives_zeros():
    """A row of length 0 under a split plan: every partial is empty, and the
    merge gives 0 / max(0, 1e-20) = 0, as the Pallas body and the plain
    version do."""
    q, kc, vc = (to_torch(_randn(s, *shape)) for s, shape in
                 ((31, (2, 1, 6, 32)), (32, (2, 256, 2, 32)),
                  (33, (2, 256, 2, 32))))
    lens = torch.tensor([0, 0], dtype=torch.int32)
    got = split_decode_model(q, kc, vc, lens, (8, 32))
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(decode_attention_plain(q, kc, vc, lens), got)


# -- (c) flash attention with P rounded to bf16 --------------------------------

def flash_bf16_model(q, k, v, causal=True, q_offset=0, kv_tile=64):
    """The tensor-core kernel's arithmetic: scores and the online softmax
    state in fp32 over KV tiles of 64, row sums of the fp32 probabilities,
    and P rounded to bf16 before P V (both products accumulate in fp32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kf = repeat_kv(k.float(), hq // hkv)
    vf = repeat_kv(v.float(), hq // hkv)
    qpos = torch.arange(sq)[:, None] + q_offset
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, kv_tile):
        ki, vi = kf[:, k0:k0 + kv_tile], vf[:, k0:k0 + kv_tile]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ki) / math.sqrt(d)
        if causal:
            kpos = torch.arange(k0, k0 + ki.shape[1])[None, :]
            s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vi)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


FLASH_CASES = [   # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset)
    (1, 130, 130, 15, 5, 64, True, 0),       # smollm's heads, ragged tiles
    (2, 40, 170, 15, 5, 64, True, 130),      # ... continuing a prefix
    (1, 96, 96, 32, 32, 80, True, 0),        # zamba2's heads
    (1, 33, 100, 32, 32, 80, True, 67),
    (2, 77, 77, 15, 5, 64, False, 0),
    (1, 1, 77, 15, 5, 64, False, 0),         # one query row, mostly masked
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,q_offset", FLASH_CASES)
def test_flash_p_in_bf16_vs_plain_and_jnp(B, Sq, Skv, Hq, Hkv, D, causal,
                                          q_offset):
    """Rounding P to bf16 is the one new error of the tensor-core path; it
    stays within the bf16 tolerance of the port's plain version and of
    JAX's ``flash_attention_jnp`` on the same bf16 inputs."""
    jdt, tdt, tol = DTYPES["bfloat16"]
    q, k, v = (_randn(41, B, Sq, Hq, D), _randn(42, B, Skv, Hkv, D),
               _randn(43, B, Skv, Hkv, D))
    tq, tk, tv = (to_torch(x, tdt) for x in (q, k, v))
    got = flash_bf16_model(tq, tk, tv, causal=causal, q_offset=q_offset)
    assert got.dtype == tdt and got.shape == (B, Sq, Hq, D)
    plain = flash_attention_plain(tq, tk, tv, causal=causal,
                                  q_offset=q_offset)
    want = JL.flash_attention_jnp(to_jax(q, jdt), to_jax(k, jdt),
                                  to_jax(v, jdt), causal=causal,
                                  q_chunk=64, kv_chunk=64, q_offset=q_offset)
    _close(got, plain, tol)
    _close(got, want, tol)


def test_flash_p_rounding_is_visible_in_fp32():
    """On fp32 inputs the rounding of P shows (so the model models
    something) and stays a quarter of the bf16 tolerance or less."""
    q, k, v = (to_torch(_randn(s, 1, 130, 15, 64)) for s in (51, 52, 53))
    k, v = k[:, :, :5].contiguous(), v[:, :, :5].contiguous()
    got = flash_bf16_model(q, k, v)
    plain = flash_attention_plain(q, k, v)
    err = float((got - plain).abs().max())
    assert 1e-5 < err < 5e-3
