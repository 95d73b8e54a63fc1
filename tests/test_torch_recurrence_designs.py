"""The arithmetic of the two recurrence kernels' designs, held on the CPU.

The CUDA kernels cannot run without a GPU, so what is tested here is what
their designs change in the function, written out in plain PyTorch in this
file (not in the package) and held against the port's plain versions, the
JAX oracles and the Pallas bodies in interpret mode on the same numpy
inputs:

  * both kernels (``csrc/rwkv6_chunk.cu``, ``csrc/ssd_chunk.cu``) run the
    four products of a chunk on the tensor cores in TF32 with each fp32
    operand split into a TF32 "hi" part and a TF32 "lo" part of the
    remainder, a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b (3xTF32); a single
    TF32 product is shown to miss the fp32 limit, which is why the split
    exists;
  * the SSD kernel folds the decays into scalar factors (the readout's
    exp(cum_i) rows, the carry's dt_j exp(cum_C - cum_j) columns, the decay
    mask times dt_j on the Gram tile) and computes the Gram tile C B^T once
    for the heads that share B and C, each head applying its own mask;
  * the model phase's default ``RunConfig().seq_chunk`` is 64 in the port.

TF32 is modelled by bit arithmetic: the low 13 mantissa bits cleared, which
is what the tensor cores read of a .tf32 operand.
Tolerances are the recurrences' own (tests/test_kernels.py): allclose with
atol = rtol = 1e-4 in fp32 and 1e-1 in bf16; 1e-3 of max|output| at the
reference init's scale (chip_smoke.py's ``ssd/init-scale``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_chunk import wkv6_pallas  # noqa: E402
from repro.kernels.ssd_chunk import ssd_pallas  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6_plain  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_plain  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from torch_port_util import as_np, to_jax, to_torch  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 1e-1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

WKV_SHAPES = [(1, 64, 2, 16, 16, 16),     # B, S, H, dk, dv, chunk
              (2, 128, 3, 16, 24, 32),    # dk != dv
              (1, 256, 2, 64, 64, 64)]    # rwkv6-7b's head at chunk 64
SSD_SHAPES = [(1, 64, 2, 16, 16, 16),     # b, S, H, P, N, chunk
              (2, 128, 3, 32, 16, 32),
              (1, 256, 2, 64, 64, 64)]    # zamba2-2.7b's head at chunk 64


# -- the 3xTF32 split -----------------------------------------------------------

def tf32(x):
    """x (fp32) truncated to TF32's 10 mantissa bits (its low 13 bits
    cleared): what the tensor cores read of a .tf32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels compute it: hi = tf32(a), lo = tf32(a - hi), and
    three TF32 products (hi hi + hi lo + lo hi), each exact in fp32 (11 x 11
    significant bits), summed in fp32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm1(a, b):
    """a @ b from one TF32 product."""
    return tf32(a) @ tf32(b)


def mm_fp32(a, b):
    return a @ b


def test_tf32_split_model():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-3, 0.0])
    got = tf32(x)
    # truncation toward zero; a TF32 value has its low 13 bits clear
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == 1.0 + 2.0 ** -10 and got[3] == -1.0
    assert bool(((got.view(torch.int32) & 0x1fff) == 0).all())
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=g) * torch.exp(
        torch.randn(64, 64, generator=g) * 8)
    assert float(((tf32(a) - a).abs() / a.abs()).max()) <= 2.0 ** -10
    hi = tf32(a)
    lo = tf32(a - hi)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -20


# -- models of the kernels' chunked forms ------------------------------------------

def wkv6_model(r, k, v, w, u, state=None, chunk=64, mm=mm3):
    """The WKV6 kernel's chunk step with its products through ``mm``: scores
    q_dec k_dec^T (strictly lower) with the u bonus, the diagonal of
    (r u) k^T, on the diagonal; scores v + q_dec S; and the carry
    exp(cum_C) S + k_rem^T v."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    st = (torch.zeros(b, h, dk, dv) if state is None else state.float())
    lower = torch.tril(torch.ones(chunk, chunk), diagonal=-1)
    eye = torch.eye(chunk)
    ys = []
    for c0 in range(0, s, chunk):
        # (b, h, C, d)
        rr, kk, vv, ww = (t[:, c0:c0 + chunk].transpose(1, 2)
                          for t in (r, k, v, w))
        lw = torch.log(ww)
        incl = torch.cumsum(lw, dim=2)          # cum_{i+1}
        prev = incl - lw                        # cum_i
        last = incl[:, :, -1:]                  # cum_C
        qd = rr * torch.exp(prev)
        kd = kk * torch.exp(-incl)
        kr = kk * torch.exp(last - incl)
        # the bonus r_i . (u * k_i): the diagonal of (r u) k^T
        bonus = mm(rr * u[None, :, None, :], kk.transpose(-1, -2)) * eye
        sc = mm(qd, kd.transpose(-1, -2)) * lower + bonus
        y = mm(sc, vv) + mm(qd, st)
        st = torch.exp(last[:, :, 0])[..., None] * st \
            + mm(kr.transpose(-1, -2), vv)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1), st


def ssd_model(x, dt, A, B, C, D, state=None, chunk=64, mm=mm3,
              shared_gram=False):
    """The SSD kernel's chunk step: the Gram tile G = C B^T (once for all
    heads with ``shared_gram``, B and C then taken from head 0), the
    readout exp(cum_i) (C h^T) + S' x + D x with S'_ij = G_ij
    exp(clip(cum_i - cum_j, -60, 0)) dt_j on j <= i, and the carry
    exp(cum_C) h + (x w)^T B with w_j = dt_j exp(cum_C - cum_j)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D = (t.float() for t in (x, dt, A, B, C, D))
    st = (torch.zeros(b, h, p, n) if state is None else state.float())
    incl_mask = torch.tril(torch.ones(chunk, chunk))
    ys = []
    for c0 in range(0, s, chunk):
        xx = x[:, c0:c0 + chunk].transpose(1, 2)           # (b, h, C, p)
        dd = dt[:, c0:c0 + chunk].transpose(1, 2)          # (b, h, C)
        BB = B[:, c0:c0 + chunk].transpose(1, 2)           # (b, h, C, n)
        CC = C[:, c0:c0 + chunk].transpose(1, 2)
        cum = torch.cumsum(dd * A[None, :, None], dim=2)
        last = cum[..., -1:]
        if shared_gram:
            G = mm(CC[:, :1], BB[:, :1].transpose(-1, -2)).expand(
                b, h, chunk, chunk)
        else:
            G = mm(CC, BB.transpose(-1, -2))
        decay = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :],
                                      -60.0, 0.0))
        sp = G * decay * dd[..., None, :] * incl_mask
        y = torch.exp(cum)[..., None] * mm(CC, st.transpose(-1, -2)) \
            + mm(sp, xx) + D[None, :, None, None] * xx
        wj = dd * torch.exp(last - cum)
        st = torch.exp(last)[..., None] * st \
            + mm((xx * wj[..., None]).transpose(-1, -2), BB)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1), st


# -- inputs (numpy, from a seed) -------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _wkv_inputs(B, S, H, dk, dv, seed=2, strong_decay=False):
    """The distributions of tests/test_kernels.py; ``strong_decay`` puts
    every log w at the models' clamp (-0.5), so that over a chunk of 64
    the factors exp(+-cum) reach e^32, where the split's error is largest."""
    g = _rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, dk) * 0.5, n(B, S, H, dk) * 0.5, n(B, S, H, dv) * 0.5
    if strong_decay:
        w = np.full((B, S, H, dk), np.exp(-0.5), np.float32)
    else:
        w = np.clip(np.exp(-np.exp(n(B, S, H, dk) * 0.5 - 1.5)), 0.62,
                    0.9999).astype(np.float32)
    u = n(H, dk) * 0.3
    s0 = n(B, H, dk, dv) * 0.1
    return r, k, v, w, u, s0


def _ssd_inputs(b, S, H, P, N, seed=3, broadcast=False):
    g = _rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(b, S, H, P) * 0.5
    dt = (np.log1p(np.exp(n(b, S, H) * 0.5)) * 0.5).astype(np.float32)
    A = -np.exp(n(H) * 0.3).astype(np.float32)
    if broadcast:
        Bm = np.repeat(n(b, S, 1, N) * 0.5, H, axis=2)
        Cm = np.repeat(n(b, S, 1, N) * 0.5, H, axis=2)
    else:
        Bm, Cm = n(b, S, H, N) * 0.5, n(b, S, H, N) * 0.5
    D = n(H) * 0.3
    h0 = n(b, H, P, N) * 0.1
    return x, dt, A, Bm, Cm, D, h0


def _pair(arrays, work, dtype):
    """The same numpy inputs for JAX and the port: the arrays at ``work`` in
    the working dtype, the rest in fp32."""
    jdt, tdt = DTYPES[dtype]
    jx = [to_jax(a, jdt) if i in work else to_jax(a)
          for i, a in enumerate(arrays)]
    tx = [to_torch(a, tdt) if i in work else to_torch(a)
          for i, a in enumerate(arrays)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def _allclose_excess(got, want, tol) -> float:
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    return float((np.abs(got - want) - tol * np.abs(want)).max())


# -- (a) the split against the reference -------------------------------------------

@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_split_matches_pallas_and_oracle(shape, dtype):
    jx, tx = _pair(_wkv_inputs(*shape[:5]), {0, 1, 2}, dtype)
    chunk, tol = shape[5], TOL[dtype]
    got = wkv6_model(*tx, chunk=chunk)
    want_p = wkv6_pallas(*jx, chunk=chunk, interpret=True)
    want_r = jref.wkv6_ref(*jx)
    for g, wp, wr in zip(got, want_p, want_r):
        _close(g, wp, tol)
        _close(g, wr, tol)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_ssd_split_matches_pallas_and_oracle(shape, dtype, broadcast):
    arrays = _ssd_inputs(*shape[:5], broadcast=broadcast)
    jx, tx = _pair(arrays, {0, 3, 4}, dtype)
    chunk, tol = shape[5], TOL[dtype]
    got = ssd_model(*tx, chunk=chunk, shared_gram=broadcast)
    want_p = ssd_pallas(*jx, chunk=chunk, interpret=True)
    want_r = jref.ssd_ref(*jx)
    for g, wp, wr in zip(got, want_p, want_r):
        _close(g, wp, tol)
        _close(g, wr, tol)


def test_wkv6_split_at_strong_decay():
    """log w = -0.5 everywhere over chunks of 64: the factors reach e^32.
    The split stays inside the fp32 limit against the plain version and
    the token-by-token oracle; one TF32 product does not."""
    tx = list(map(to_torch, _wkv_inputs(1, 128, 2, 64, 64, seed=21,
                                        strong_decay=True)))
    plain = wkv6_plain(*tx, chunk=64)
    oracle = ref.wkv6_ref(*tx)
    split = wkv6_model(*tx, chunk=64)
    for g, p, o in zip(split, plain, oracle):
        _close(g, p, 1e-4)
        _close(g, o, 1e-4)
    single = wkv6_model(*tx, chunk=64, mm=mm1)
    assert max(_allclose_excess(g, p, 1e-4)
               for g, p in zip(single, plain)) > 1e-4


@pytest.mark.parametrize("op", ["wkv6", "ssd"])
def test_single_pass_tf32_misses_the_fp32_limit(op):
    """At the main paths' head shape (64 x 64, chunk 64) one TF32 product
    per matmul leaves the fp32 allclose(1e-4) against the plain version,
    and the 3xTF32 split is inside it: the reason the kernels split."""
    if op == "wkv6":
        tx = list(map(to_torch, _wkv_inputs(1, 256, 2, 64, 64, seed=22)))
        plain = wkv6_plain(*tx, chunk=64)
        model = lambda mm: wkv6_model(*tx, chunk=64, mm=mm)  # noqa: E731
    else:
        tx = list(map(to_torch, _ssd_inputs(1, 256, 2, 64, 64, seed=23,
                                            broadcast=True)))
        plain = ssd_plain(*tx, chunk=64)
        model = lambda mm: ssd_model(*tx, chunk=64, mm=mm,  # noqa: E731
                                     shared_gram=True)
    one = max(_allclose_excess(g, p, 1e-4)
              for g, p in zip(model(mm1), plain))
    three = max(_allclose_excess(g, p, 1e-4)
                for g, p in zip(model(mm3), plain))
    assert one > 1e-4
    assert three <= 1e-4
    assert three < one / 10


def test_ssd_split_at_the_reference_init_scale():
    """zamba2-2.7b's mixers under the reference's init (dt ~ 17, prefix
    sums ~1e4): the split stays within 1e-3 of max|output| of the plain
    version, the limit chip_smoke.py holds the kernel to there."""
    g = _rng(13)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    b, S, H, P, N = 1, 256, 4, 64, 64
    dt = np.log1p(np.exp(n(b, S, H) * 17.0)).astype(np.float32)
    A = -np.linspace(1.0, 8.0, H, dtype=np.float32)
    silu = lambda a: (a / (1.0 + np.exp(-a))).astype(np.float32)  # noqa: E731
    x = silu(n(b, S, H, P) * 6.8)
    bc = silu(n(b, S, 1, 2 * N) * 6.8)
    Bm, Cm = (np.repeat(t, H, axis=2) for t in (bc[..., :N], bc[..., N:]))
    D, h0 = n(H) * 0.3, np.zeros((b, H, P, N), np.float32)
    tx = list(map(to_torch, (x, dt, A, Bm, Cm, D, h0)))
    got = ssd_model(*tx, chunk=64, shared_gram=True)
    want = ssd_plain(*tx, chunk=64)
    for a, w in zip(got, want):
        a, w = as_np(a).astype(np.float64), as_np(w).astype(np.float64)
        assert np.abs(a - w).max() / np.abs(w).max() < 1e-3


# -- (b) the shared Gram tile ---------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_shared_gram_equals_per_head_scores(chunk):
    """With B and C shared over the heads, one C B^T and a per-head mask
    exp(clip(cum_i - cum_j, -60, 0)) on j <= i give the per-head scores of
    the plain chunked form, and the whole model with one Gram tile equals
    the one with a tile per head, bit for bit."""
    x, dt, A, Bm, Cm, D, h0 = map(to_torch, _ssd_inputs(
        1, 128, 4, 32, 64, seed=24, broadcast=True))
    cc, bb = Cm[:, :chunk], Bm[:, :chunk]
    cum = torch.cumsum(dt[:, :chunk] * A[None, None, :], dim=1)
    incl = torch.tril(torch.ones(chunk, chunk))
    decay = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                  -60.0, 0.0))              # (b, i, j, H)
    per_head = torch.einsum("bihn,bjhn->bijh", cc, bb) * decay \
        * incl[None, :, :, None]
    gram = torch.einsum("bin,bjn->bij", cc[:, :, 0], bb[:, :, 0])
    shared = gram[..., None] * decay * incl[None, :, :, None]
    _close(shared, per_head, 1e-6)
    one = ssd_model(x, dt, A, Bm, Cm, D, h0, chunk=chunk, shared_gram=True)
    each = ssd_model(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    for a, e in zip(one, each):
        assert torch.equal(a, e)
    for a, p in zip(one, ssd_plain(x, dt, A, Bm, Cm, D, h0, chunk=chunk)):
        _close(a, p, 1e-4)


def test_folded_decays_equal_the_chunked_form_in_fp32():
    """The kernels' factorisation (decays folded into row and column
    factors, the Gram tile masked per head), evaluated with exact fp32
    products, is the plain chunked form up to fp32 round-off."""
    tw = list(map(to_torch, _wkv_inputs(2, 128, 3, 16, 24, seed=25)))
    for a, p in zip(wkv6_model(*tw, chunk=32, mm=mm_fp32),
                    wkv6_plain(*tw, chunk=32)):
        _close(a, p, 2e-5)
    ts = list(map(to_torch, _ssd_inputs(2, 128, 3, 32, 16, seed=26)))
    for a, p in zip(ssd_model(*ts, chunk=32, mm=mm_fp32),
                    ssd_plain(*ts, chunk=32)):
        _close(a, p, 2e-5)


# -- RunConfig's seq_chunk default ------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b"])
def test_forward_on_the_default_run_config_matches_jax(name):
    """The port's default ``RunConfig()`` takes chunks of 64, which the
    kernels' wrappers accept: ``forward`` over two chunks runs and equals
    the JAX forward at ``seq_chunk=64`` on the same weights. RWKV6 within
    the model tolerance (2e-4, allclose). Zamba2 within 2e-4 of max|logit|:
    under the reference's init its chunked SSD is ill-conditioned (ROADMAP
    C), and the JAX forward itself moves by ~2.2e-4 between chunks of 8 and
    of 64 on these weights, so no ordering of the sums meets an absolute
    2e-4 on the smallest logits."""
    import jax
    from repro.models.api import RunConfig as JRun, build_model as jbuild
    from repro_torch import convert
    from torch_port_util import jax_tree_to_numpy, reduced_pair

    assert RunConfig().seq_chunk == 64
    cj, ct = reduced_pair(name)
    mj = jbuild(cj, JRun(seq_chunk=64))
    pj = mj.init_params(jax.random.PRNGKey(0))
    mt = build_model(ct, RunConfig(), device="cpu")
    convert.load_params(mt, jax_tree_to_numpy(pj))
    toks = np.random.default_rng(0).integers(0, ct.vocab, (1, 128)).astype(
        np.int32)
    want = as_np(mj.forward(pj, {"tokens": jnp.asarray(toks)}))
    with torch.inference_mode():
        got = mt.forward({"tokens": torch.from_numpy(toks)})
    assert got.shape == (1, 128, ct.vocab)
    assert bool(torch.isfinite(got).all())
    if name == "rwkv6-7b":
        np.testing.assert_allclose(as_np(got), want, atol=2e-4, rtol=2e-4)
    else:
        assert np.abs(as_np(got) - want).max() <= 2e-4 * np.abs(want).max()
