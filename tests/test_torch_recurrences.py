"""Port parity for the two recurrences (WKV6, Mamba-2 SSD) and for the
attention kernels' plain versions at zamba2's head_dim 80.

The CUDA kernels cannot run without a GPU; what is held against the JAX
package here is everything around them: the port's token-by-token oracles
(``ref.py``), its chunked forms (``chunked.py``, the kernels' plain
versions) and the wrappers, which take the plain version for a CPU tensor.
References: the JAX oracles, the JAX chunked forms and the Pallas bodies in
interpret mode, on the sweeps of tests/test_kernels.py. Tolerances are the
reference's own: 2e-5 in fp32 and 2e-2 in bf16, x5 for the recurrences;
for bf16 both sides round the same numpy input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunked as jchunked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.rwkv6_chunk import wkv6_pallas  # noqa: E402
from repro.kernels.ssd_chunk import ssd_pallas  # noqa: E402
from repro_torch.kernels import chunked, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6, wkv6_plain  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd  # noqa: E402
from torch_port_util import as_np, to_jax, to_torch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

WKV_SHAPES = [(1, 64, 2, 16, 16, 16),     # B, S, H, dk, dv, chunk
              (2, 128, 3, 16, 24, 32),    # dk != dv
              (1, 256, 2, 32, 32, 64)]
SSD_SHAPES = [(1, 64, 2, 16, 16, 16),     # b, S, H, P, N, chunk
              (2, 128, 3, 32, 16, 32),
              (1, 256, 2, 64, 32, 64)]


def _rng(seed):
    return np.random.default_rng(seed)


def _wkv_inputs(B, S, H, dk, dv, seed=2):
    """numpy float32: the distributions of tests/test_kernels.py."""
    g = _rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, dk) * 0.5, n(B, S, H, dk) * 0.5, n(B, S, H, dv) * 0.5
    w = np.clip(np.exp(-np.exp(n(B, S, H, dk) * 0.5 - 1.5)), 0.62,
                0.9999).astype(np.float32)
    u = n(H, dk) * 0.3
    s0 = n(B, H, dk, dv) * 0.1
    return r, k, v, w, u, s0


def _ssd_inputs(b, S, H, P, N, seed=3):
    g = _rng(seed)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(b, S, H, P) * 0.5
    dt = (np.log1p(np.exp(n(b, S, H) * 0.5)) * 0.5).astype(np.float32)
    A = -np.exp(n(H) * 0.3).astype(np.float32)
    Bm, Cm = n(b, S, H, N) * 0.5, n(b, S, H, N) * 0.5
    D = n(H) * 0.3
    h0 = n(b, H, P, N) * 0.1
    return x, dt, A, Bm, Cm, D, h0


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def _wkv_pair(shape, dtype):
    """The same inputs for JAX and for the port: r, k, v in the working
    dtype, w, u and the state in fp32."""
    jdt, tdt, tol = DTYPES[dtype]
    r, k, v, w, u, s0 = _wkv_inputs(*shape[:5])
    jx = [to_jax(a, jdt) for a in (r, k, v)] + [to_jax(a) for a in (w, u, s0)]
    tx = [to_torch(a, tdt) for a in (r, k, v)] + [to_torch(a)
                                                  for a in (w, u, s0)]
    return jx, tx, tol * 5


def _ssd_pair(shape, dtype):
    """x, B and C in the working dtype; dt, A, D and the state in fp32."""
    jdt, tdt, tol = DTYPES[dtype]
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(*shape[:5])
    work = {0, 3, 4}
    arrays = (x, dt, A, Bm, Cm, D, h0)
    jx = [to_jax(a, jdt) if i in work else to_jax(a)
          for i, a in enumerate(arrays)]
    tx = [to_torch(a, tdt) if i in work else to_torch(a)
          for i, a in enumerate(arrays)]
    return jx, tx, tol * 5


# -- WKV6 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_ref_and_chunked_match_jax(shape, dtype):
    jx, tx, tol = _wkv_pair(shape, dtype)
    chunk = shape[5]
    y_jr, s_jr = jref.wkv6_ref(*jx)
    y_tr, s_tr = ref.wkv6_ref(*tx)
    _close(y_tr, y_jr, tol)
    _close(s_tr, s_jr, tol)
    y_jc, s_jc = jchunked.wkv6_chunked(*jx, chunk=chunk)
    y_tc, s_tc = chunked.wkv6_chunked(*tx, chunk=chunk)
    assert y_tc.dtype == torch.float32 and y_tc.shape == shape[:3] + (shape[4],)
    _close(y_tc, y_jc, tol)
    _close(s_tc, s_jc, tol)
    _close(y_tc, y_jr, tol)


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_wrapper_matches_pallas_interpret(shape, dtype):
    """The wrapper on a CPU tensor (its plain version) against the Pallas
    body, output and final state."""
    jx, tx, tol = _wkv_pair(shape, dtype)
    chunk = shape[5]
    y_p, s_p = wkv6_pallas(*jx, chunk=chunk, interpret=True)
    y_t, s_t = wkv6(*tx, chunk=chunk)
    _close(y_t, y_p, tol)
    _close(s_t, s_p, tol)


def test_wkv6_decode_matches_jax():
    r, k, v, w, u, s0 = _wkv_inputs(2, 1, 3, 16, 24, seed=5)
    yj, sj = jchunked.wkv6_decode(*map(to_jax, (r, k, v, w, u, s0)))
    yt, st = chunked.wkv6_decode(*map(to_torch, (r, k, v, w, u, s0)))
    _close(yt, yj, 2e-5)
    _close(st, sj, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [[0, 5, 0, 3], [0, 0, 0, 0], 7])
def test_wkv6_decode_wrapper_on_the_cpu_is_the_plain_form(dtype, cache_len):
    """``ops.wkv6_decode(impl="kernel")`` on CPU tensors is the plain form
    bit for bit: y returned, the new state written into the cache's slice
    itself and no other layer's. A row at length 0 comes out as
    ``chunked.wkv6_decode`` from zero state, whatever stale state it held;
    a continuing row as ``chunked.wkv6_decode`` from its state."""
    _, tdt, tol = DTYPES[dtype]
    r, k, v, w, u, s0 = _wkv_inputs(4, 1, 3, 16, 24, seed=21)
    r, k, v = (to_torch(a, tdt) for a in (r, k, v))
    w, u = to_torch(w), to_torch(u)
    stale = to_torch(s0) * 50.0                   # stale values in every row
    caches = {impl: torch.stack([stale, stale.clone()]).clone()
              for impl in ("kernel", "plain")}
    ys = {}
    for impl, cache in caches.items():
        slot = cache[1]
        ptr = slot.data_ptr()
        ys[impl] = ops.wkv6_decode(r, k, v, w, u, slot, cache_len, impl=impl)
        assert slot.data_ptr() == ptr
        assert torch.equal(cache[0], stale)       # the other layer's slice
    assert ys["kernel"].shape == (4, 1, 3, 24)
    assert ys["kernel"].dtype == torch.float32
    assert torch.equal(ys["kernel"], ys["plain"])
    assert torch.equal(caches["kernel"], caches["plain"])
    lens = np.broadcast_to(np.asarray(cache_len), (4,))
    for i, n in enumerate(lens):
        start = stale[i:i + 1] if n > 0 else torch.zeros_like(stale[i:i + 1])
        y1, s1 = chunked.wkv6_decode(r[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     w[i:i + 1], u, start)
        assert torch.equal(ys["kernel"][i:i + 1], y1)
        assert torch.equal(caches["kernel"][1, i:i + 1], s1)
    # the token-by-token oracle agrees
    cache = torch.stack([stale, stale.clone()]).clone()
    y_ref = ops.wkv6_decode(r, k, v, w, u, cache[1], cache_len,
                            impl="reference")
    _close(y_ref, ys["plain"], tol * 5)
    _close(cache[1], caches["plain"][1], tol * 5)


@pytest.mark.parametrize("bad", ["dv6", "dk129", "dv132", "u", "state",
                                 "strided", "dtype"])
def test_wkv6_decode_kernel_refuses_shapes_it_does_not_take(bad):
    """The wrapper's checks before a launch (CUDA only, so called here
    directly): every head size up to 128 with dv a multiple of 4 is taken,
    anything else raises instead of reaching the kernel."""
    from repro_torch.kernels import wkv6_decode as wd

    def args(b=2, h=3, dk=16, dv=16):
        t = lambda *s: torch.zeros(s)  # noqa: E731
        return [t(b, 1, h, dk), t(b, 1, h, dk), t(b, 1, h, dv),
                t(b, 1, h, dk), t(h, dk), t(b, h, dk, dv)]

    for dk, dv in ((1, 4), (16, 24), (64, 64), (128, 128), (100, 128)):
        wd._check(*args(dk=dk, dv=dv))
    a = {"dv6": args(dv=6), "dk129": args(dk=129, dv=128),
         "dv132": args(dk=4, dv=132)}.get(bad) or args()
    if bad == "u":
        a[4] = torch.zeros(3, 8)
    elif bad == "state":
        a[5] = torch.zeros(2, 3, 16, 12)
    elif bad == "strided":
        a[5] = torch.zeros(2, 3, 16, 32)[..., :16]
    elif bad == "dtype":
        a[1] = a[1].to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        wd._check(*a)


def test_wkv6_chunk_size_and_zero_state():
    """The chunk is a tiling choice: every chunk size gives the token-by-
    token answer; no initial state means zeros."""
    r, k, v, w, u, _ = map(to_torch, _wkv_inputs(1, 64, 2, 16, 16, seed=6))
    want, s_want = ref.wkv6_ref(r, k, v, w, u)
    for chunk in (1, 8, 16, 64):
        y, s = wkv6_plain(r, k, v, w, u, chunk=chunk)
        _close(y, want, 1e-4)
        _close(s, s_want, 1e-4)
    zero = torch.zeros((1, 2, 16, 16))
    assert torch.equal(wkv6_plain(r, k, v, w, u, zero, chunk=16)[0],
                       wkv6_plain(r, k, v, w, u, chunk=16)[0])
    with pytest.raises(ValueError, match="divisible"):
        wkv6_plain(r, k, v, w, u, chunk=48)


# -- SSD ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_and_chunked_match_jax(shape, dtype):
    jx, tx, tol = _ssd_pair(shape, dtype)
    chunk = shape[5]
    y_jr, h_jr = jref.ssd_ref(*jx)
    y_tr, h_tr = ref.ssd_ref(*tx)
    _close(y_tr, y_jr, tol)
    _close(h_tr, h_jr, tol)
    y_jc, h_jc = jchunked.ssd_chunked(*jx, chunk=chunk)
    y_tc, h_tc = chunked.ssd_chunked(*tx, chunk=chunk)
    assert y_tc.dtype == torch.float32 and y_tc.shape == shape[:4]
    _close(y_tc, y_jc, tol)
    _close(h_tc, h_jc, tol)
    _close(y_tc, y_jr, tol)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_wrapper_matches_pallas_interpret(shape, dtype):
    jx, tx, tol = _ssd_pair(shape, dtype)
    chunk = shape[5]
    y_p, h_p = ssd_pallas(*jx, chunk=chunk, interpret=True)
    y_t, h_t = ssd(*tx, chunk=chunk)
    _close(y_t, y_p, tol)
    _close(h_t, h_p, tol)


def test_ssd_decode_matches_jax():
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(2, 1, 3, 16, 8, seed=7)
    args = (x, dt, A, Bm, Cm, D, h0)
    yj, hj = jchunked.ssd_decode(*map(to_jax, args))
    yt, ht = chunked.ssd_decode(*map(to_torch, args))
    _close(yt, yj, 2e-5)
    _close(ht, hj, 2e-5)


def test_ssd_broadcast_bc_view_equals_contiguous():
    """The model hands B and C over as one (b, S, N) tensor broadcast over
    the heads (head stride 0) and x as a strided view: the same numbers as
    contiguous copies."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(2, 32, 3, 8, 16, seed=8)
    b1, c1 = to_torch(Bm[:, :, :1]), to_torch(Cm[:, :, :1])
    bv, cv = b1.expand(2, 32, 3, 16), c1.expand(2, 32, 3, 16)
    assert bv.stride(2) == 0
    xt = to_torch(np.concatenate([x, x], axis=-1))[..., :8]
    assert not xt.is_contiguous()
    args = (to_torch(dt), to_torch(A))
    got = ssd(xt, *args, bv, cv, to_torch(D), to_torch(h0), chunk=16)
    want = ssd(xt.contiguous(), *args, bv.contiguous(), cv.contiguous(),
               to_torch(D), to_torch(h0), chunk=16)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


def _normalised_err(got, want) -> float:
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_ssd_chunked_at_the_reference_init_scale():
    """What zamba2-2.7b's mixers see under the reference's init (in_proj
    outputs of std ~17: dt = softplus(N(0, 17)), x, B, C = silu(N(0, 6.8)),
    A = -linspace(1, 8, H)). The in-chunk prefix sums of dt*A reach ~1e4,
    where one fp32 ulp is ~1e-3, and the chunked form's decays exp(cum_i -
    cum_j) inherit that round-off; the token-by-token oracle does not. Both
    chunked forms, the port's and JAX's, stay within a quarter of the 1e-3
    of max|y| that chip_smoke.py allows the kernel against the chunked form
    at this scale."""
    g = _rng(13)
    n = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    b, S, H, P, N = 1, 256, 4, 64, 64
    dt = np.log1p(np.exp(n(b, S, H) * 17.0)).astype(np.float32)
    A = -np.linspace(1.0, 8.0, H, dtype=np.float32)
    silu = lambda a: (a / (1.0 + np.exp(-a))).astype(np.float32)  # noqa: E731
    x, Bm, Cm = silu(n(b, S, H, P) * 6.8), silu(n(b, S, H, N) * 6.8), \
        silu(n(b, S, H, N) * 6.8)
    D, h0 = n(H) * 0.3, np.zeros((b, H, P, N), np.float32)
    args = (x, dt, A, Bm, Cm, D, h0)
    assert float((dt * A).cumsum(axis=1).min()) < -3e3
    want = ref.ssd_ref(*map(to_torch, args))
    port = chunked.ssd_chunked(*map(to_torch, args), chunk=64)
    jax_ = jchunked.ssd_chunked(*map(to_jax, args), chunk=64)
    for got in (port, jax_):
        for a, w in zip(got, want):
            assert _normalised_err(a, w) < 2.5e-4


@pytest.mark.parametrize("op", ["wkv6", "ssd"])
def test_wrappers_take_the_same_chunks_on_the_cpu(op):
    """The wrapper refuses a chunk above 64 (RunConfig's default of 256
    among them) on a CPU tensor as it does on a CUDA one; the plain
    chunked form itself still computes it."""
    if op == "wkv6":
        fn, plain = wkv6, wkv6_plain
        args = list(map(to_torch, _wkv_inputs(1, 256, 2, 16, 16, seed=14)))
    else:
        fn, plain = ssd, chunked.ssd_chunked
        args = list(map(to_torch, _ssd_inputs(1, 256, 2, 16, 16, seed=15)))
    for chunk in (128, 256, 48):
        with pytest.raises(ValueError, match="chunk"):
            fn(*args, chunk=chunk)
    y, _ = plain(*args, chunk=128)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(fn(*args, chunk=64)[0], plain(*args, chunk=64)[0])


# -- dispatch -----------------------------------------------------------------

def test_ops_dispatch_recurrences_on_the_cpu():
    tw = list(map(to_torch, _wkv_inputs(1, 32, 2, 16, 16, seed=9)))
    ts = list(map(to_torch, _ssd_inputs(1, 32, 2, 16, 16, seed=10)))
    before = ops.launch_counts()
    for op, args in ((ops.wkv6, tw), (ops.ssd, ts)):
        a = op(*args, chunk=16, impl="kernel")
        b = op(*args, chunk=16, impl="plain")
        c = op(*args, impl="reference")
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)            # CPU tensor: wrapper == plain
            _close(x, z, 1e-4)
        with pytest.raises(ValueError):
            op(*args, impl="pallas")
    assert torch.equal(ops.wkv6(*tw, impl="reference")[0],
                       ref.wkv6_ref(*tw)[0])
    assert torch.equal(ops.ssd(*ts, impl="reference")[0], ref.ssd_ref(*ts)[0])
    # no kernel was launched on the CPU, so no counter moved
    assert ops.launch_counts() == before
    assert set(before) == {"decode_attention", "flash_attention", "wkv6",
                           "ssd", "grouped_matmul", "grouped_swiglu",
                           "wkv6_decode", "add_rms_norm", "rope_kv_write",
                           "silu_mul"}


# -- attention at head_dim 80 (zamba2-2.7b's shared block) --------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_head_dim_80_vs_pallas_interpret(dtype, causal):
    jdt, tdt, tol = DTYPES[dtype]
    g = _rng(11)
    q, k, v = (g.standard_normal((1, 128, 4, 80)).astype(np.float32)
               for _ in range(3))
    want = flash_attention_pallas(to_jax(q, jdt), to_jax(k, jdt),
                                  to_jax(v, jdt), causal=causal, block_q=64,
                                  block_kv=64, interpret=True)
    got = flash_attention_plain(to_torch(q, tdt), to_torch(k, tdt),
                                to_torch(v, tdt), causal=causal, q_chunk=64,
                                kv_chunk=64)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_head_dim_80_vs_pallas_interpret(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    g = _rng(12)
    q = g.standard_normal((2, 1, 4, 80)).astype(np.float32)
    kc, vc = (g.standard_normal((2, 256, 4, 80)).astype(np.float32)
              for _ in range(2))
    want = decode_attention_pallas(to_jax(q, jdt), to_jax(kc, jdt),
                                   to_jax(vc, jdt), jnp.array(77, jnp.int32),
                                   block_kv=64, interpret=True)
    got = decode_attention_plain(to_torch(q, tdt), to_torch(kc, tdt),
                                 to_torch(vc, tdt), 77)
    _close(got, want, tol)
