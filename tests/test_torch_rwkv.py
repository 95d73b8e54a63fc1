"""Port parity for RWKV6Model: the same numpy inputs and the same weights
(drawn by the reference's init, carried over as numpy) through the JAX model
and the port's, on reduced rwkv6-7b configs in fp32. Logits within 2e-4,
the reference's own model tolerance (tests/test_models_smoke.py).

Also the one place where the port departs from the reference on purpose:
the reference's ``decode_step`` ignores ``cache_len``, so under continuous
batching a request admitted into a slot that served or idled before starts
from that slot's leftover state; the port starts a row whose length is 0
from zero state, and its batched tokens equal a solo ``Replica.generate``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.serving.engine import (ContinuousBatcher as JBatcher,  # noqa: E402
                                  Replica as JReplica)
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.models.rwkv import RWKV6Model  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, Replica  # noqa: E402
from repro_torch.serving.exec_cache import ExecutableCache  # noqa: E402
from torch_port_util import (as_np, jax_tree_to_numpy, model_pair,  # noqa: E402
                             reduced_pair)

TOL = dict(atol=2e-4, rtol=2e-4)

# name -> reduced() overrides: the default (head_dim 16) and wider heads
CONFIGS = {"rwkv6-7b": {},
           "rwkv6-7b/hd32": dict(n_heads=2, d_model=64, d_ff=96)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return model_pair("rwkv6-7b", **CONFIGS[request.param])


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_build_model_returns_rwkv6():
    model = build_model(get_config("rwkv6-7b").reduced(), device="cpu")
    assert isinstance(model, RWKV6Model)


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
    tensor), logits and every state leaf."""
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
    for name in ("wkv", "shift_att", "shift_ffn"):
        np.testing.assert_allclose(as_np(ct[name]), as_np(cj[name]), **TOL)


def test_per_row_lengths_from_a_fresh_cache_match_jax(pair):
    """A (B,) length vector, every row starting at 0 together: the
    reference (which ignores the lengths) and the port agree."""
    mj, pj, mt = pair
    toks = _tokens(mt.cfg.vocab, 3, 5, seed=2)
    cj = mj.init_cache(JShape("t", 16, 3, "decode"))
    ct = mt.init_cache(ShapeSpec("t", 16, 3, "decode"))
    for t in range(5):
        lens = np.full((3,), t, np.int32)
        lj, cj = mj.decode_step(pj, cj, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.asarray(lens)})
        with torch.inference_mode():
            lt, ct = mt.decode_step(ct, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": torch.from_numpy(lens)})
        np.testing.assert_allclose(as_np(lt), as_np(lj), **TOL)


def test_row_at_length_zero_starts_from_zero_state(pair):
    """A row whose length is 0 ignores what its cache rows hold; a row whose
    length is positive carries on from them."""
    _, _, mt = pair
    b = 3
    g = torch.Generator().manual_seed(0)
    dirty = {k: torch.randn(v.shape, generator=g)
             for k, v in mt.init_cache(ShapeSpec("t", 8, b, "decode")).items()}
    fresh = mt.init_cache(ShapeSpec("t", 8, b, "decode"))
    tok = torch.from_numpy(_tokens(mt.cfg.vocab, b, 1, seed=3))
    lens = torch.tensor([0, 4, 0], dtype=torch.int32)
    with torch.inference_mode():
        ld, dirty = mt.decode_step(dict(dirty), {"tokens": tok,
                                                 "cache_len": lens})
        lf, _ = mt.decode_step(fresh, {"tokens": tok, "cache_len": 0})
    for row in (0, 2):
        assert torch.equal(ld[row], lf[row])
    assert not torch.allclose(ld[1], lf[1])


def test_prefill_decode_consistency(pair):
    """Within the port: token-by-token decode reproduces the parallel
    forward's last logits (the chunked recurrence against the step form)."""
    _, _, mt = pair
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 16, seed=4))
    with torch.inference_mode():
        want = mt.forward({"tokens": toks})[:, -1]
        cache = mt.init_cache(ShapeSpec("t", 32, 2, "decode"))
        for t in range(16):
            got, cache = mt.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": t})
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


@pytest.mark.parametrize("impl", ["plain", "reference"])
def test_attn_impl_switch_agrees(impl):
    _, _, mt = model_pair("rwkv6-7b")
    other = build_model(mt.cfg, RunConfig(attn_impl=impl, seq_chunk=8),
                        device="cpu")
    other.load_state_dict(mt.state_dict())
    toks = torch.from_numpy(_tokens(mt.cfg.vocab, 2, 16, seed=5))
    with torch.inference_mode():
        np.testing.assert_allclose(as_np(other.forward({"tokens": toks})),
                                   as_np(mt.forward({"tokens": toks})), **TOL)


def test_init_params_scales_and_determinism():
    cfg = get_config("rwkv6-7b").reduced(n_layers=16, d_model=64, n_heads=4,
                                         d_ff=128, vocab=2048)
    m1 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    m2 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    sd = m1.state_dict()
    assert all(torch.equal(v, m2.state_dict()[k]) for k, v in sd.items())
    for k in ("layers.ln1", "layers.ln2", "layers.gn", "ln_in", "final_norm"):
        assert float(sd[k].min()) == 1.0 == float(sd[k].max())
    for k in ("layers.ln1b", "layers.gnb", "ln_inb", "final_normb"):
        assert float(sd[k].abs().max()) == 0.0
    assert float(sd["layers.mu_r"].min()) == 0.5 == float(
        sd["layers.mu_cr"].max())
    assert float(sd["layers.decay_base"].max()) == -2.0
    assert abs(float(sd["layers.bonus_u"].std()) - 0.3) < 0.03
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    # the reference hands dense_init the stacked shape: fan_in is L
    assert abs(float(sd["layers.w_r"].std()) - 16 ** -0.5) < 5e-3
    assert abs(float(sd["lm_head"].std()) - 64 ** -0.5) < 5e-3
    # every key of the reference's tree, nothing else
    mj, pj, _ = model_pair("rwkv6-7b")
    assert set(convert.flatten_tree(jax_tree_to_numpy(pj))) == set(
        build_model(get_config("rwkv6-7b").reduced(),
                    device="cpu").state_dict())


# -- continuous batching: the reference's slot-state leak ----------------------

TINY_KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512)
FIRST, SECOND, REUSED = [5, 9, 13], [7, 3, 11, 2, 8, 1, 4], [21, 6, 30, 2]


def _reuse_slot(batcher):
    """Two requests in a 2-slot batcher; when the first finishes, a third
    is admitted into its slot, which has served and then idled. Returns the
    third request's tokens."""
    a = batcher.add_request(FIRST, max_new=3)
    batcher.add_request(SECOND, max_new=12)
    while a not in batcher.finished:
        batcher.step()
    batcher.step()                          # the freed slot idles a step
    c = batcher.add_request(REUSED, max_new=6)
    return batcher.run_until_done()[c]


@pytest.fixture(scope="module")
def replicas():
    cj, ct = reduced_pair("rwkv6-7b", **TINY_KW)
    jrep = JReplica(cj, max_seq=64)
    trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(), device="cpu")
    convert.load_params(trep.model, jax_tree_to_numpy(jrep.params))
    return jrep, trep


def test_reference_batcher_leaks_state_into_a_reused_slot(replicas):
    jrep, _ = replicas
    solo = jrep.generate(REUSED, max_new_tokens=6)
    assert _reuse_slot(JBatcher(jrep, max_slots=2)) != solo


def test_port_batcher_reused_slot_equals_solo_generate(replicas):
    jrep, trep = replicas
    solo = jrep.generate(REUSED, max_new_tokens=6)
    assert trep.generate(REUSED, max_new_tokens=6) == solo
    assert _reuse_slot(ContinuousBatcher(trep, max_slots=2)) == solo


def test_serves_through_the_live_backend():
    """The unchanged serving stack (Cluster -> LiveBackend -> batcher ->
    RWKV6Model.decode_step) on the CPU: every request's tokens equal a solo
    Replica.generate on its sandbox's weights."""
    from repro_torch.core import Cluster, Function, ScalingConfig
    from repro_torch.core.request import LiveRequest
    from repro_torch.live import LiveBackend, LiveFunctionSpec
    from repro_torch.simcore import Environment

    cfg = get_config("rwkv6-7b").reduced(**TINY_KW)
    sandbox_of = {}

    class Backend(LiveBackend):
        def admit(self, sandbox_id, req):
            sandbox_of[id(req)] = sandbox_id
            return super().admit(sandbox_id, req)

    cache = ExecutableCache()
    lb = Backend(default_spec=LiveFunctionSpec(
        cfg=cfg, max_seq=64, max_slots=2, default_max_new=4),
        exec_cache=cache, device="cpu")
    env = Environment(seed=5)
    cl = Cluster(env, n_workers=2, runtime="firecracker", live_backend=lb,
                 sandbox_concurrency=2)
    cl.start()
    leader = cl.control_plane_leader()
    leader.install_function(Function(
        name="rwkv", image_url="img://rwkv", port=80,
        scaling=ScalingConfig(stable_window=1.0, panic_window=1.0,
                              scale_to_zero_grace=0.2)))
    for dp in cl.data_planes:
        dp.sync_functions(["rwkv"])
    prompts = [[1 + i, 7, 3 * i % 11 + 2][: 2 + i % 2] for i in range(5)]
    invs = []

    def client(env):
        for p in prompts:
            invs.append(cl.invoke("rwkv", 0.01, request=LiveRequest(
                prompt=p, max_new_tokens=4)))
            yield env.timeout(0.001)

    env.process(client(env), name="client")
    env.run(until=30.0)
    assert all(i.t_done > 0 and not i.failed for i in invs)
    for p, inv in zip(prompts, invs):
        sid = sandbox_of[id(inv.request)]
        solo = Replica(cfg, rng_seed=sid, max_seq=64, exec_cache=cache,
                       device="cpu").generate(p, max_new_tokens=4)
        assert inv.request.tokens == solo
    lb.close()
