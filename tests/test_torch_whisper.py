"""Port parity for WhisperModel: the same numpy frames and tokens and the same
weights (drawn by the reference's init, carried over as numpy) through the
JAX model and the port's, on reduced whisper-small in fp32. Logits within
2e-4, the reference's own model tolerance (tests/test_models_smoke.py);
the loss within 2e-4 and every gradient leaf within atol 1e-4, rtol 1e-3
(``assert_grads_close``: atol in units of a leaf's largest gradient where
that exceeds 1).

The pair is built once for the module: ``dec_pos`` alone is 524,296 rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.whisper import MAX_DEC_POS, WhisperModel  # noqa: E402
from torch_port_util import (as_np, assert_grads_close, attn_impl,  # noqa: E402
                             grads_of, model_pair, torch_threads)

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def pair():
    return model_pair("whisper-small")


def _inputs(cfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, cfg.enc_dec.encoder_seq, cfg.d_model))
              * 0.5).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return frames, toks[:, :-1], toks[:, 1:]


def _jbatch(frames, toks, labels=None):
    out = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    if labels is not None:
        out["labels"] = jnp.asarray(labels)
    return out


def _tbatch(frames, toks, labels=None):
    out = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    if labels is not None:
        out["labels"] = torch.from_numpy(labels)
    return out


def test_build_model_returns_whisper():
    model = build_model(get_config("whisper-small").reduced(), device="cpu")
    assert isinstance(model, WhisperModel)
    assert model.dec_pos.shape == (MAX_DEC_POS, 64)
    assert (model.enc_layers, model.enc_seq) == (2, 24)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_keys_and_shapes_equal_param_specs(pair):
    mj, _, mt = pair
    specs = _flat_specs(mj.param_specs())
    sd = mt.state_dict()
    assert set(sd) == set(specs)
    for k, spec in specs.items():
        assert tuple(sd[k].shape) == tuple(spec.shape), k
        assert str(sd[k].dtype).replace("torch.", "") == str(spec.dtype), k


def test_converter_carries_the_nested_tree_both_ways(pair):
    _, pj, mt = pair
    back = convert.to_numpy_tree(mt.state_dict())
    assert set(back) == set(pj)
    assert set(back["encoder"]) == set(pj["encoder"])
    assert set(back["decoder"]) == set(pj["decoder"])
    for k in ("embed", "enc_final_lnb"):
        np.testing.assert_array_equal(back[k], np.asarray(pj[k]))
    np.testing.assert_array_equal(back["decoder"]["x_wk"],
                                  np.asarray(pj["decoder"]["x_wk"]))


def test_encode_matches_jax(pair):
    mj, pj, mt = pair
    frames, _, _ = _inputs(mt.cfg)
    want = mj.encode(pj, jnp.asarray(frames))
    with torch.inference_mode():
        got = mt.encode(torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_forward_matches_jax(pair):
    mj, pj, mt = pair
    frames, toks, _ = _inputs(mt.cfg, s=13, seed=1)
    want = mj.forward(pj, _jbatch(frames, toks))
    with torch.inference_mode():
        got = mt.forward(_tbatch(frames, toks))
    assert got.shape == (2, 13, mt.cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_prefill_cross_and_decode_step_match_jax(pair):
    """Driven as tests/test_models_smoke.py::test_decode_step drives the
    reference: a 64-long cache, cross K/V from prefill_cross, then one step
    at cache_len 3; logits and every cache leaf."""
    mj, pj, mt = pair
    frames, _, _ = _inputs(mt.cfg, seed=2)
    b = 2
    cj = mj.prefill_cross(pj, jnp.asarray(frames),
                          mj.init_cache(JShape("t", 64, b, "decode")))
    ct = mt.init_cache(ShapeSpec("t", 64, b, "decode"))
    with torch.inference_mode():
        ct2 = mt.prefill_cross(torch.from_numpy(frames), ct)
    assert ct2 is ct
    for k in ("xk", "xv"):
        np.testing.assert_allclose(as_np(ct[k]), as_np(cj[k]), **TOL)
    tok = np.ones((b, 1), np.int32)
    lj, cj = jax.jit(mj.decode_step)(pj, cj, {
        "tokens": jnp.asarray(tok), "cache_len": jnp.array(3, jnp.int32)})
    with torch.inference_mode():
        lt, _ = mt.decode_step(ct, {"tokens": torch.from_numpy(tok),
                                    "cache_len": 3})
    assert lt.shape == (b, mt.cfg.vocab)
    np.testing.assert_allclose(as_np(lt), as_np(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[k]), as_np(cj[k]), **TOL)


def test_token_by_token_decode_matches_forward(pair):
    """The port's decode (K1's plain version for the self and the cross
    attention) against its own forward (K2's), at every position, with the
    length given as an int, a 0-d tensor and a (B,) tensor of equal
    entries."""
    _, _, mt = pair
    frames, toks, _ = _inputs(mt.cfg, s=9, seed=3)
    with torch.inference_mode():
        want = mt.forward(_tbatch(frames, toks))
        cache = mt.prefill_cross(torch.from_numpy(frames),
                                 mt.init_cache(ShapeSpec("t", 16, 2,
                                                         "decode")))
        for t in range(toks.shape[1]):
            clen = [t, torch.tensor(t), torch.full((2,), t)][t % 3]
            got, cache = mt.decode_step(cache, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": clen})
            np.testing.assert_allclose(as_np(got), as_np(want[:, t]), **TOL)


def test_per_row_lengths_must_agree(pair):
    _, _, mt = pair
    cache = mt.init_cache(ShapeSpec("t", 16, 2, "decode"))
    with torch.inference_mode(), pytest.raises(ValueError, match="ROADMAP"):
        mt.decode_step(cache, {"tokens": torch.ones((2, 1), dtype=torch.int32),
                               "cache_len": torch.tensor([3, 4])})


def test_attn_impl_switch_agrees(pair):
    """"kernel" on CPU tensors is the plain version; "reference" is the
    O(S^2) oracle."""
    _, _, mt = pair
    frames, toks, _ = _inputs(mt.cfg, s=7, seed=4)
    outs = {}
    for impl in ("kernel", "plain", "reference"):
        with attn_impl(mt, impl), torch.inference_mode():
            outs[impl] = mt.forward(_tbatch(frames, toks))
    assert torch.equal(outs["kernel"], outs["plain"])
    np.testing.assert_allclose(as_np(outs["reference"]), as_np(outs["plain"]),
                               **TOL)


def test_loss_and_grads_match_jax(pair):
    mj, pj, mt = pair
    frames, toks, labels = _inputs(mt.cfg, s=12, seed=5)
    lj, gj = jax.value_and_grad(mj.loss_fn)(pj, _jbatch(frames, toks, labels))
    gj = convert.flatten_tree(jax.tree.map(np.asarray, gj))
    loss, gt = grads_of(mt, _tbatch(frames, toks, labels))
    np.testing.assert_allclose(float(loss), float(lj), **TOL)
    assert_grads_close(gt, gj)


def test_init_params_follows_the_reference_rule():
    cfg = get_config("whisper-small").reduced()
    m = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    sd = m.state_dict()
    for k in ("enc_final_ln", "decoder.s_ln", "encoder.mln"):
        assert bool((sd[k] == 1).all()), k
    for k in ("dec_final_lnb", "decoder.x_lnb", "encoder.b_up",
              "decoder.b_down"):
        assert bool((sd[k] == 0).all()), k
    assert abs(float(sd["dec_pos"][:4096].std()) - 0.02) < 1e-3
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    # the stacked shape's fan-in (L = 2), as the reference's dense_init
    assert abs(float(sd["decoder.x_wq"].std()) - 2 ** -0.5) < 0.02
    fan = m.init_params(torch.Generator().manual_seed(0),
                        layer_fan_in=True).state_dict()
    assert abs(float(fan["decoder.x_wq"].std()) - 64 ** -0.5) < 5e-3
    assert abs(float(fan["encoder.w_down"].std()) - 128 ** -0.5) < 5e-3
    assert abs(float(fan["dec_pos"][:4096].std()) - 0.02) < 1e-3
