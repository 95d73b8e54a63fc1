"""Port parity for DecoderLM: the same numpy inputs and the same weights
(drawn by the reference's init, carried over as numpy) through the JAX model
and the port's, on reduced configs in fp32. Logits within 2e-4, the
reference's own model tolerance (tests/test_models_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from torch_port_util import as_np, model_pair  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)

# name -> reduced() overrides; together they cover swiglu and gelu MLPs,
# qk_norm, tied and untied heads, GQA / MQA, a group of three query heads
# per KV head (the full smollm-360m ratio, 15 : 5), MoE layers with and
# without arctic's dense residual (models/moe.py) and M-RoPE (qwen2-vl)
CONFIGS = {
    "smollm-360m": {},
    "qwen3-32b": {},
    "glm4-9b": {},
    "granite-34b": {},
    "smollm-360m/group3": dict(n_heads=6, n_kv_heads=2, d_model=96),
    "kimi-k2-1t-a32b": {},
    "arctic-480b": {},
    "qwen2-vl-72b": {},
}


def _pair(key, **kw):
    return model_pair(key.split("/")[0], **{**CONFIGS[key], **kw})


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_forward_matches_jax(key):
    mj, pj, mt = _pair(key)
    toks = _tokens(mt.cfg.vocab, 2, 21)       # ragged against chunks of 8
    want = mj.forward(pj, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = mt.forward({"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 21, mt.cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_decode_step_scalar_length_matches_jax(key):
    mj, pj, mt = _pair(key)
    toks = _tokens(mt.cfg.vocab, 2, 6, seed=1)
    cj = mj.init_cache(JShape("t", 16, 2, "decode"))
    ct = mt.init_cache(ShapeSpec("t", 16, 2, "decode"))
    for t in range(6):
        lj, cj = mj.decode_step(pj, cj, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.array(t, jnp.int32)})
        with torch.inference_mode():
            # int and 0-d tensor are both taken
            clen = t if t % 2 else torch.tensor(t, dtype=torch.int32)
            lt, ct2 = mt.decode_step(ct, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": clen})
        assert ct2 is ct                      # updated in place
        np.testing.assert_allclose(as_np(lt), as_np(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[name]), as_np(cj[name]), **TOL)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_decode_step_per_slot_lengths_matches_jax(key):
    """The continuous-batching form: one cache length per row, an inactive
    row at length 0 included; the KV scatter and the (B, 1) position
    offsets must land where the reference puts them."""
    mj, pj, mt = _pair(key)
    b = 3
    toks = _tokens(mt.cfg.vocab, b, 5, seed=2)
    lens = np.array([0, 3, 7], np.int32)
    cj = mj.init_cache(JShape("t", 16, b, "decode"))
    ct = mt.init_cache(ShapeSpec("t", 16, b, "decode"))
    # distinct cache contents below each row's length
    fill = np.random.default_rng(3).standard_normal(
        as_np(cj["k"]).shape).astype(np.float32) * 0.3
    cj = {"k": jnp.asarray(fill), "v": jnp.asarray(fill[..., ::-1].copy())}
    ct = {"k": torch.from_numpy(fill.copy()),
          "v": torch.from_numpy(fill[..., ::-1].copy())}
    for t in range(5):
        step_lens = lens + np.array([0, t, t], np.int32)   # row 0 stays idle
        lj, cj = mj.decode_step(pj, cj, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.asarray(step_lens)})
        with torch.inference_mode():
            lt, ct = mt.decode_step(ct, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": torch.from_numpy(step_lens)})
        assert lt.shape == (b, mt.cfg.vocab)
        np.testing.assert_allclose(as_np(lt), as_np(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[name]), as_np(cj[name]), **TOL)


@pytest.mark.parametrize("key", ["qwen3-32b", "smollm-360m/group3",
                                 "arctic-480b", "qwen2-vl-72b"])
def test_prefill_decode_consistency(key):
    """Within the port: token-by-token decode reproduces the parallel
    forward's last logits (KV cache, positions and lengths carry over)."""
    _, _, mt = _pair(key)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, b, s, seed=4))
    with torch.inference_mode():
        want = mt.forward({"tokens": toks})[:, -1]
        cache = mt.init_cache(ShapeSpec("t", 32, b, "decode"))
        for t in range(s):
            got, cache = mt.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": t})
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


@pytest.mark.parametrize("impl", ["plain", "reference"])
def test_attn_impl_switch_agrees(impl):
    _, _, mt = _pair("smollm-360m/group3")
    other = build_model(mt.cfg, RunConfig(attn_impl=impl, q_chunk=8,
                                          kv_chunk=8), device="cpu")
    other.load_state_dict(mt.state_dict())
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 11, seed=5))
    with torch.inference_mode():
        np.testing.assert_allclose(as_np(other.forward({"tokens": toks})),
                                   as_np(mt.forward({"tokens": toks})), **TOL)


def test_init_params_scales_and_determinism():
    cfg = get_config("smollm-360m").reduced(n_layers=16, d_model=64,
                                            n_heads=4, d_ff=128, vocab=2048)
    m1 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    m2 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    sd = m1.state_dict()
    assert all(torch.equal(v, m2.state_dict()[k]) for k, v in sd.items())
    assert float(sd["layers.ln1"].min()) == 1.0 == float(sd["final_norm"].max())
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    # the reference hands dense_init the stacked shape: fan_in is L
    assert abs(float(sd["layers.wq"].std()) - 16 ** -0.5) < 5e-3
    assert "lm_head" not in sd                      # tied head
    gelu = build_model(get_config("granite-34b").reduced(), device="cpu")
    gelu.init_params(torch.Generator().manual_seed(0))
    assert float(gelu.state_dict()["layers.b_up"].abs().max()) == 0.0
    untied = build_model(get_config("qwen3-32b").reduced(), device="cpu")
    assert "lm_head" in untied.state_dict()


@pytest.mark.parametrize("name,item", [("whisper-small", "A11")])
def test_unported_families_name_their_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(get_config(name).reduced(), device="cpu")
