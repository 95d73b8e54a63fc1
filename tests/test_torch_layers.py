"""Port parity: every function of repro_torch.models.layers against its JAX
counterpart on the same numpy inputs (fp32 atol/rtol 2e-5: elementwise and
short-reduction arithmetic, only the summation order differs)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_port_util import as_np, to_jax, to_torch  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
RNG = np.random.default_rng(0)


def _x(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **(tol or TOL))


def test_dense_init_scale_shape_dtype():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (64, 512, 256), torch.float32)
    assert w.shape == (64, 512, 256) and w.dtype == torch.float32
    # fan_in is shape[0], as in the reference (handed stacked shapes)
    assert abs(float(w.std()) - 1.0 / math.sqrt(64)) < 2e-3
    e = TL.dense_init(g, (2048, 64), torch.bfloat16, scale=0.02)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 2e-3
    b = TL.dense_init(g, (4096,), torch.float32)       # 1-D: fan_in 1
    assert abs(float(b.std()) - 1.0) < 5e-2
    # same seed, same numbers
    a1 = TL.dense_init(torch.Generator().manual_seed(3), (4, 4))
    a2 = TL.dense_init(torch.Generator().manual_seed(3), (4, 4))
    assert torch.equal(a1, a2)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 4, 16)])
def test_rms_norm(shape):
    x, w = _x(*shape, scale=3.0), _x(shape[-1])
    _close(TL.rms_norm(to_torch(x), to_torch(w)),
           JL.rms_norm(to_jax(x), to_jax(w)))


def test_rms_norm_bf16_casts_back():
    x, w = _x(2, 7, 64, scale=3.0), _x(64)
    got = TL.rms_norm(to_torch(x, torch.bfloat16), to_torch(w))
    want = JL.rms_norm(to_jax(x, jnp.bfloat16), to_jax(w))
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=2e-2, rtol=2e-2)   # one bf16 rounding apart


def test_layer_norm():
    x, w, b = _x(2, 5, 64, scale=2.0), _x(64), _x(64)
    _close(TL.layer_norm(to_torch(x), to_torch(w), to_torch(b)),
           JL.layer_norm(to_jax(x), to_jax(w), to_jax(b)))
    # the model's call: zero bias
    z = np.zeros(64, np.float32)
    _close(TL.layer_norm(to_torch(x), to_torch(w), to_torch(z)),
           JL.layer_norm(to_jax(x), to_jax(w), to_jax(z)))


@pytest.mark.parametrize("d,theta", [(16, 1e4), (64, 1e4), (128, 1e6)])
def test_rope_freqs(d, theta):
    _close(TL.rope_freqs(d, theta), JL.rope_freqs(d, theta),
           atol=0, rtol=2e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_split_half_with_per_slot_offsets(theta):
    x = _x(3, 6, 4, 32)
    # per-slot offsets as the batcher makes them: (B, 1) + arange(S)
    pos = (np.arange(6, dtype=np.int32)[None, :]
           + np.array([[0], [17], [900]], np.int32))
    _close(TL.apply_rope(to_torch(x), to_torch(pos), theta),
           JL.apply_rope(to_jax(x), to_jax(pos), theta))
    # the hoisted form the model uses is the same function
    cos, sin = TL.rope_tables(to_torch(pos), 32, theta)
    assert torch.equal(TL.rotate(to_torch(x), cos, sin),
                       TL.apply_rope(to_torch(x), to_torch(pos), theta))
    # split-half, not interleaved: position 0 is the identity
    same = TL.apply_rope(to_torch(x), torch.zeros(3, 6, dtype=torch.int32))
    _close(same, x, atol=0, rtol=0)


@pytest.mark.parametrize("groups", [1, 3, 4])
def test_repeat_kv(groups):
    k = _x(2, 5, 2, 8)
    got = TL.repeat_kv(to_torch(k), groups)
    _close(got, JL.repeat_kv(to_jax(k), groups), atol=0, rtol=0)
    assert got.shape == (2, 5, 2 * groups, 8)


@pytest.mark.parametrize("causal,sq,skv,q_offset", [
    (True, 12, 12, 0), (False, 12, 12, 0), (True, 5, 12, 7), (False, 5, 9, 0)])
def test_attention_reference(causal, sq, skv, q_offset):
    q, k, v = _x(2, sq, 3, 16), _x(2, skv, 3, 16), _x(2, skv, 3, 16)
    _close(TL.attention_reference(to_torch(q), to_torch(k), to_torch(v),
                                  causal=causal, q_offset=q_offset),
           JL.attention_reference(to_jax(q), to_jax(k), to_jax(v),
                                  causal=causal, q_offset=q_offset))


def test_swiglu():
    x, wg, wu, wd = _x(2, 3, 32), _x(32, 48, scale=0.2), \
        _x(32, 48, scale=0.2), _x(48, 32, scale=0.2)
    _close(TL.swiglu(*map(to_torch, (x, wg, wu, wd))),
           JL.swiglu(*map(to_jax, (x, wg, wu, wd))))


def test_gelu_mlp():
    x, wu, bu, wd, bd = _x(2, 3, 32), _x(32, 48, scale=0.2), _x(48), \
        _x(48, 32, scale=0.2), _x(32)
    _close(TL.gelu_mlp(*map(to_torch, (x, wu, bu, wd, bd))),
           JL.gelu_mlp(*map(to_jax, (x, wu, bu, wd, bd))))
