"""Port parity for Zamba2Model: the same numpy inputs and the same weights
(drawn by the reference's init, carried over as numpy) through the JAX model
and the port's, on reduced zamba2-2.7b configs in fp32. Logits within 2e-4,
the reference's own model tolerance (tests/test_models_smoke.py).

The reference's ``decode_step`` takes one scalar ``cache_len`` for the
batch; the port takes the same, and a ``(B,)`` length whose entries differ
raises instead of being silently misread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.serving.engine import Replica as JReplica  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.models.ssm import Zamba2Model  # noqa: E402
from repro_torch.serving.engine import Replica  # noqa: E402
from repro_torch.serving.exec_cache import ExecutableCache  # noqa: E402
from torch_port_util import (as_np, jax_tree_to_numpy, model_pair,  # noqa: E402
                             reduced_pair)

TOL = dict(atol=2e-4, rtol=2e-4)

# name -> reduced() overrides: the default (one super-block of two mixers,
# head_dim 16) and two super-blocks with GQA in the shared attention
CONFIGS = {"zamba2-2.7b": {},
           "zamba2-2.7b/gqa": dict(n_layers=4, n_heads=4, n_kv_heads=2)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return model_pair("zamba2-2.7b", **CONFIGS[request.param])


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_build_model_returns_zamba2():
    model = build_model(get_config("zamba2-2.7b").reduced(), device="cpu")
    assert isinstance(model, Zamba2Model)
    assert (model.n_super, model.per_super, model.n_ssm_heads) == (1, 2, 8)


def test_forward_matches_jax(pair):
    mj, pj, mt = pair
    toks = _tokens(mt.cfg.vocab, 2, 24)            # three chunks of 8
    want = mj.forward(pj, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = mt.forward({"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, mt.cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_decode_step_matches_jax(pair):
    """Token by token from a fresh cache, scalar lengths (int and 0-d
    tensor), logits and every cache leaf (SSD state, conv tail, KV)."""
    mj, pj, mt = pair
    toks = _tokens(mt.cfg.vocab, 2, 6, seed=1)
    cj = mj.init_cache(JShape("t", 16, 2, "decode"))
    ct = mt.init_cache(ShapeSpec("t", 16, 2, "decode"))
    for t in range(6):
        lj, cj = mj.decode_step(pj, cj, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.array(t, jnp.int32)})
        with torch.inference_mode():
            clen = t if t % 2 else torch.tensor(t, dtype=torch.int32)
            lt, ct2 = mt.decode_step(ct, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": clen})
        assert ct2 is ct                      # updated in place
        np.testing.assert_allclose(as_np(lt), as_np(lj), **TOL)
    # the SSD state of the reduced init reaches the hundreds: its leaves are
    # held to 2e-4 of their own scale
    for name in ("ssd", "conv", "k", "v"):
        want = as_np(cj[name])
        np.testing.assert_allclose(as_np(ct[name]), want, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(want).max()))


def test_prefill_decode_consistency(pair):
    """Within the port: token-by-token decode (SSD step form, conv tail,
    shared attention over the KV caches) reproduces the parallel forward's
    last logits."""
    _, _, mt = pair
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 16, seed=4))
    with torch.inference_mode():
        want = mt.forward({"tokens": toks})[:, -1]
        cache = mt.init_cache(ShapeSpec("t", 32, 2, "decode"))
        for t in range(16):
            got, cache = mt.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": t})
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_per_row_lengths_must_agree():
    """One length per batch, as in the reference: equal (B,) entries are
    that length; differing ones raise, naming the ROADMAP entry."""
    _, _, mt = model_pair("zamba2-2.7b")
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 1, seed=6))
    with torch.inference_mode():
        c1 = mt.init_cache(ShapeSpec("t", 8, 2, "decode"))
        a, _ = mt.decode_step(c1, {"tokens": toks, "cache_len": 0})
        c2 = mt.init_cache(ShapeSpec("t", 8, 2, "decode"))
        b, _ = mt.decode_step(c2, {"tokens": toks,
                                   "cache_len": torch.zeros(2, dtype=torch.int32)})
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="ROADMAP"):
            mt.decode_step(c2, {"tokens": toks,
                                "cache_len": torch.tensor([1, 3])})


@pytest.mark.parametrize("impl", ["plain", "reference"])
def test_attn_impl_switch_agrees(impl):
    _, _, mt = model_pair("zamba2-2.7b")
    other = build_model(mt.cfg, RunConfig(attn_impl=impl, q_chunk=8,
                                          kv_chunk=8, seq_chunk=8),
                        device="cpu")
    other.load_state_dict(mt.state_dict())
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 16, seed=5))
    with torch.inference_mode():
        np.testing.assert_allclose(as_np(other.forward({"tokens": toks})),
                                   as_np(mt.forward({"tokens": toks})), **TOL)


def test_init_params_scales_and_determinism():
    cfg = get_config("zamba2-2.7b").reduced(n_layers=4, d_model=128,
                                            vocab=2048)
    m1 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    m2 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    sd = m1.state_dict()
    assert all(torch.equal(v, m2.state_dict()[k]) for k, v in sd.items())
    for k in ("mamba.ln", "shared.ln1", "shared.ln2", "final_norm"):
        assert float(sd[k].min()) == 1.0 == float(sd[k].max())
    for k in ("mamba.D", "mamba.dt_bias", "mamba.conv_b"):
        assert float(sd[k].abs().max()) == 0.0
    h = m1.n_ssm_heads
    assert sd["mamba.A_log"].shape == (2, 2, h)
    np.testing.assert_allclose(as_np(sd["mamba.A_log"][1, 0]),
                               np.log(np.linspace(1.0, 8.0, h)), rtol=1e-6)
    assert abs(float(sd["mamba.conv_w"].std()) - 0.2) < 0.02
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    # the reference hands dense_init the stacked shape: fan_in is n_super
    assert abs(float(sd["mamba.in_proj"].std()) - 2 ** -0.5) < 0.02
    assert abs(float(sd["shared.wq"].std()) - 128 ** -0.5) < 5e-3
    mj, pj, _ = model_pair("zamba2-2.7b")
    assert set(convert.flatten_tree(jax_tree_to_numpy(pj))) == set(
        build_model(get_config("zamba2-2.7b").reduced(),
                    device="cpu").state_dict())


def test_generate_tokens_equal_jax():
    """Zamba2's serving entry point: Replica.generate (batch 1, scalar
    lengths) gives the JAX replica's greedy tokens on the same weights."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512)
    cj, ct = reduced_pair("zamba2-2.7b", **kw)
    jrep = JReplica(cj, max_seq=64)
    trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(), device="cpu")
    convert.load_params(trep.model, jax_tree_to_numpy(jrep.params))
    for prompt in ([3, 1, 4, 1, 5], [9]):
        assert trep.generate(prompt, max_new_tokens=8) == \
            jrep.generate(prompt, max_new_tokens=8)


def _forward_decode_gap(cfg, impl, chunk, **init_kw):
    """max |forward - token-by-token decode| on the last logits."""
    toks = torch.from_numpy(_tokens(cfg.vocab, 1, 128, seed=7))
    m = build_model(cfg, RunConfig(attn_impl=impl, seq_chunk=chunk),
                    device="cpu").init_params(
        torch.Generator().manual_seed(1), **init_kw)
    with torch.inference_mode():
        fwd = m.forward({"tokens": toks})[:, -1]
        cache = m.init_cache(ShapeSpec("t", 128, 1, "decode"))
        for t in range(128):
            dec, cache = m.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": t})
    return float((fwd - dec).abs().max())


def _conditioning_config():
    from dataclasses import replace

    return replace(get_config("zamba2-2.7b"), d_model=256, n_heads=4,
                   n_kv_heads=4, head_dim=64, d_ff=512, vocab=512,
                   n_layers=6, dtype="float32")


def test_chunked_ssd_conditioning_at_init_scale():
    """Why chip_smoke.py draws zamba2's weights with ``layer_fan_in``: at
    the reference init's scale (in_proj fan_in = n_super, so dt ~ 17 and
    dt*A down to ~-136 a step) the in-chunk prefix sums of dt*A reach the
    thousands, and exp(cum_i - cum_j) inherits their fp32 round-off. The
    token-by-token oracle stays within the model tolerance of decode; the
    chunked form drifts further, more so for longer chunks."""
    cfg = _conditioning_config()
    gaps = {(impl, chunk): _forward_decode_gap(cfg, impl, chunk)
            for impl, chunk in (("reference", 64), ("plain", 16),
                                ("plain", 64))}
    assert gaps[("reference", 64)] < 2e-4
    assert gaps[("reference", 64)] < gaps[("plain", 16)] \
        < gaps[("plain", 64)] < 1e-1


def test_layer_fan_in_init_is_well_conditioned():
    """``init_params(layer_fan_in=True)`` redraws only the stacked Mamba
    matrices, at 1/sqrt(their per-layer fan-in), from the same draws; the
    chunked forward then meets decode within the model tolerance."""
    cfg = _conditioning_config()
    sd = {}
    for flag in (False, True):
        m = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(1), layer_fan_in=flag)
        sd[flag] = m.state_dict()
    for k, v in sd[False].items():
        if k in ("mamba.in_proj", "mamba.out_proj"):
            fan_in, n_super = v.shape[-2], v.shape[0]
            np.testing.assert_allclose(
                as_np(sd[True][k]), as_np(v) * (n_super / fan_in) ** 0.5,
                rtol=1e-5, atol=1e-7)
            assert abs(float(sd[True][k].std()) - fan_in ** -0.5) \
                < 0.05 * fan_in ** -0.5
        else:
            assert torch.equal(sd[True][k], v)
    assert _forward_decode_gap(cfg, "plain", 64, layer_fan_in=True) < 2e-4


def test_bf16_forward_decode_gap_matches_the_reference():
    """In bf16 the hybrid under the reference's init is ill-conditioned: the
    JAX model's own forward and token-by-token decode drift apart layer by
    layer. The port drifts by the same order, and its forward stays as close
    to JAX's as JAX's forward is to its decode."""
    from dataclasses import replace

    from repro.configs import get_config as jax_get
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.models.api import RunConfig as JRun, build_model as jbuild
    import jax

    kw = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
              vocab=512, n_layers=6, dtype="bfloat16")
    mj = jbuild(replace(jax_get("zamba2-2.7b"), **kw), JRun(seq_chunk=32))
    pj = mj.init_params(jax.random.PRNGKey(0))
    mt = build_model(replace(get_config("zamba2-2.7b"), **kw),
                     RunConfig(seq_chunk=32), device="cpu")
    convert.load_params(mt, jax_tree_to_numpy(pj))
    s = 64
    toks = _tokens(512, 1, s, seed=8)
    fj = as_np(mj.forward(pj, {"tokens": jnp.asarray(toks)})[:, -1])
    cj = mj.init_cache(JShapeSpec("t", s, 1, "decode"))
    jdecode = jax.jit(mj.decode_step)
    with torch.inference_mode():
        ft = as_np(mt.forward({"tokens": torch.from_numpy(toks)})[:, -1])
        ct = mt.init_cache(ShapeSpec("t", s, 1, "decode"))
        for t in range(s):
            dj, cj = jdecode(pj, cj, {
                "tokens": jnp.asarray(toks[:, t:t + 1]),
                "cache_len": jnp.array(t, jnp.int32)})
            dt, ct = mt.decode_step(ct, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": t})
    jax_gap = float(np.abs(fj - as_np(dj)).max())
    port_gap = float(np.abs(ft - as_np(dt)).max())
    assert 0 < jax_gap and port_gap <= 2 * jax_gap + 0.05
    assert float(np.abs(ft - fj).max()) <= 2 * jax_gap + 0.05
