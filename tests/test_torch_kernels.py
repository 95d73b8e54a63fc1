"""Port parity for the two attention kernels' plain versions.

The CUDA kernels cannot run without a GPU; what is held against the JAX
package here is the plain PyTorch version beside each of them — the
arithmetic the kernels repeat and are compared with on the card
(``chip_smoke.py``). References: the Pallas kernel bodies in interpret mode
and the blocked / masked jnp forms. Tolerances are the reference's own
(tests/test_kernels.py): 2e-5 in fp32, 2e-2 in bf16; for bf16 both sides
round the same numpy input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.models.layers import repeat_kv  # noqa: E402
from torch_port_util import as_np, to_jax, to_torch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed=0):
    return (_randn(seed, B, Sq, Hq, D), _randn(seed + 1, B, Skv, Hkv, D),
            _randn(seed + 2, B, Skv, Hkv, D))


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


# -- decode attention ---------------------------------------------------------

@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,bkv,clen", [
    (1, 256, 2, 2, 64, 64, 256),
    (2, 256, 4, 2, 64, 128, 130),
    (2, 512, 8, 1, 128, 256, 7),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_pallas_interpret(B, Smax, Hq, Hkv, D, bkv, clen,
                                          dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, kc, vc = _qkv(B, 1, Smax, Hq, Hkv, D, seed=1)
    want = decode_attention_pallas(
        to_jax(q, jdt), to_jax(kc, jdt), to_jax(vc, jdt),
        jnp.array(clen, jnp.int32), block_kv=bkv, interpret=True)
    got = decode_attention_plain(to_torch(q, tdt), to_torch(kc, tdt),
                                 to_torch(vc, tdt), clen)
    assert got.dtype == tdt and got.shape == (B, 1, Hq, D)
    _close(got, want, tol)


@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,lens", [
    (4, 64, 6, 2, 32, [1, 64, 17, 33]),        # group size 3; 1 and Smax
    (3, 48, 4, 4, 16, [48, 1, 20]),            # MHA
    (2, 96, 8, 1, 64, [96, 5]),                # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_jnp_per_row_lengths(B, Smax, Hq, Hkv, D, lens,
                                             dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, kc, vc = _qkv(B, 1, Smax, Hq, Hkv, D, seed=2)
    want = JL.decode_attention_jnp(
        to_jax(q, jdt), to_jax(kc, jdt), to_jax(vc, jdt),
        jnp.array(lens, jnp.int32))
    got = decode_attention_plain(
        to_torch(q, tdt), to_torch(kc, tdt), to_torch(vc, tdt),
        torch.tensor(lens, dtype=torch.int32))
    _close(got, want, tol)


def test_decode_scalar_forms_agree():
    q, kc, vc = map(to_torch, _qkv(2, 1, 32, 6, 2, 16, seed=3))
    a = decode_attention_plain(q, kc, vc, 9)
    b = decode_attention_plain(q, kc, vc, torch.tensor(9))
    c = decode_attention_plain(q, kc, vc, torch.tensor([9, 9]))
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError):
        decode_attention_plain(q, kc, vc, torch.tensor([9, 9, 9]))


def test_decode_length_zero_follows_the_pallas_body():
    """cache_len == 0: the Pallas body skips every block and returns 0; the
    port's plain version (and its kernel) do the same, where
    decode_attention_jnp would average the whole cache."""
    q, kc, vc = _qkv(2, 1, 64, 4, 2, 32, seed=4)
    want = decode_attention_pallas(to_jax(q), to_jax(kc), to_jax(vc),
                                   jnp.array(0, jnp.int32), block_kv=32,
                                   interpret=True)
    got = decode_attention_plain(*map(to_torch, (q, kc, vc)),
                                 torch.tensor([0, 3]))
    assert float(np.abs(as_np(want)).max()) == 0.0
    assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) > 0


# -- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bkv", [
    (1, 128, 2, 2, 64, 64, 64),      # MHA
    (2, 256, 4, 2, 64, 128, 64),     # GQA
    (1, 128, 4, 1, 128, 32, 128),    # MQA, wide head
    (2, 192, 3, 3, 32, 64, 96),      # non-pow2 blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_pallas_interpret(B, S, Hq, Hkv, D, bq, bkv, dtype,
                                         causal):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, S, S, Hq, Hkv, D)
    want = flash_attention_pallas(to_jax(q, jdt), to_jax(k, jdt),
                                  to_jax(v, jdt), causal=causal, block_q=bq,
                                  block_kv=bkv, interpret=True)
    got = flash_attention_plain(to_torch(q, tdt), to_torch(k, tdt),
                                to_torch(v, tdt), causal=causal, q_chunk=bq,
                                kv_chunk=bkv)
    assert got.dtype == tdt and got.shape == (B, S, Hq, D)
    _close(got, want, tol)


@pytest.mark.parametrize("Sq,Skv,q_chunk,kv_chunk,causal,q_offset", [
    (77, 77, 32, 16, True, 0),        # ragged tails on both axes
    (77, 77, 32, 16, False, 0),
    (50, 131, 16, 64, True, 81),      # q_offset > 0, Sq != Skv
    (13, 40, 512, 1024, True, 27),    # chunks larger than the sequences
    (1, 33, 8, 8, True, 32),          # one query row against a cache
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_jnp_ragged_and_offset(Sq, Skv, q_chunk, kv_chunk,
                                              causal, q_offset, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(2, Sq, Skv, 6, 2, 32, seed=5)       # group size 3
    want = JL.flash_attention_jnp(
        to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt), causal=causal,
        q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    got = flash_attention_plain(
        to_torch(q, tdt), to_torch(k, tdt), to_torch(v, tdt), causal=causal,
        q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    _close(got, want, tol)


# -- dispatch -----------------------------------------------------------------

def test_ops_dispatch_and_cpu_wrappers_take_the_plain_version():
    q, k, v = map(to_torch, _qkv(1, 64, 64, 6, 2, 32, seed=6))
    before = ops.launch_counts()
    a = ops.flash_attention(q, k, v, q_chunk=32, kv_chunk=32, impl="kernel")
    b = ops.flash_attention(q, k, v, q_chunk=32, kv_chunk=32, impl="plain")
    c = ops.flash_attention(q, k, v, impl="reference")
    assert torch.equal(a, b)               # CPU tensor: wrapper == plain
    _close(a, c, 2e-5)
    _close(c, ref.flash_attention_ref(q, repeat_kv(k, 3), repeat_kv(v, 3)),
           0.0)
    assert torch.equal(flash_attention(q, k, v, q_chunk=32, kv_chunk=32), b)
    lens = torch.tensor([40], dtype=torch.int32)
    d1 = ops.decode_attention(q[:, :1], k, v, lens, impl="kernel")
    d2 = ops.decode_attention(q[:, :1], k, v, lens, impl="plain")
    assert torch.equal(d1, d2)
    assert torch.equal(decode_attention(q[:, :1], k, v, lens), d2)
    assert torch.equal(ref.decode_attention_ref(q[:, :1], k, v, lens), d2)
    # no kernel was launched on the CPU, so no counter moved
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :1], k, v, lens, impl="auto")


def test_build_is_lazy_and_keyed_by_source_hash(tmp_path, monkeypatch):
    """Importing the kernel modules builds nothing; the build directory is
    keyed by the sources' hash; without nvcc a build raises, it does not
    fall back."""
    from repro_torch.kernels import build

    assert {p.name for p in build.CSRC.glob("*.cu")} >= {
        "decode_attention.cu", "flash_attention.cu"}
    h = build.source_hash()
    assert h == build.source_hash() and h != build.source_hash(["-v"])
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build.build_root() == tmp_path
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    import os
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(build.KernelBuildError):
            build.build()
        assert not list(tmp_path.glob("**/*.so"))
