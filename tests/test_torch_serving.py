"""Port parity and behaviour of the serving engine (Replica,
ContinuousBatcher, sample_token, ExecutableCache) on the CPU.

Greedy token streams must equal the JAX package's on the same weights. The
weights come from the reference's seeded init, carried over as numpy; with
this seed the top-two logit gap at every generated position is orders of
magnitude above the 1e-5 cross-framework difference, so no argmax tie can
flip a token (``test_greedy_margin_is_wide`` pins that)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving.engine import (ContinuousBatcher as JBatcher,  # noqa: E402
                                  Replica as JReplica)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.serving.engine import (ContinuousBatcher, Replica,  # noqa: E402
                                        sample_token)
from repro_torch.serving.exec_cache import (ExecutableCache,  # noqa: E402
                                            default_cache,
                                            reset_default_cache)
from torch_port_util import jax_tree_to_numpy, reduced_pair  # noqa: E402
from repro_torch import convert  # noqa: E402

TINY_KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128)
TINY = get_config("smollm-360m").reduced(**TINY_KW)
PROMPTS = [[1, 2, 3, 4], [5, 6], [7, 8, 9]]


@pytest.fixture(scope="module")
def pair():
    """(jax replica, torch replica) serving identical weights."""
    cj, ct = reduced_pair("smollm-360m", **TINY_KW)
    jrep = JReplica(cj, max_seq=64)
    trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(), device="cpu")
    convert.load_params(trep.model, jax_tree_to_numpy(jrep.params))
    return jrep, trep


@pytest.fixture(scope="module")
def replica():
    return Replica(TINY, max_seq=64, exec_cache=ExecutableCache(),
                   device="cpu")


# -- parity with the JAX engine -------------------------------------------------

@pytest.mark.parametrize("prompt", PROMPTS + [[9]])
def test_generate_tokens_equal_jax(pair, prompt):
    jrep, trep = pair
    assert trep.generate(prompt, max_new_tokens=8) == \
        jrep.generate(prompt, max_new_tokens=8)


def test_batcher_tokens_equal_jax(pair):
    jrep, trep = pair
    jb, tb = JBatcher(jrep, max_slots=4), ContinuousBatcher(trep, max_slots=4)
    jr = [jb.add_request(p, max_new=6) for p in PROMPTS]
    tr = [tb.add_request(p, max_new=6) for p in PROMPTS]
    # mid-flight admission on both sides at the same step
    for _ in range(3):
        jb.step()
        tb.step()
    jr.append(jb.add_request([11, 12], max_new=5))
    tr.append(tb.add_request([11, 12], max_new=5))
    jb.run_until_done()
    tb.run_until_done()
    assert tb.steps == jb.steps
    assert [tb.finished[r] for r in tr] == [jb.finished[r] for r in jr]


def test_greedy_margin_is_wide(pair):
    """The seed's guarantee behind the two tests above."""
    _, trep = pair
    cache = trep.new_cache(1)
    toks = list(PROMPTS[0])
    gaps = []
    for t in range(len(toks) + 8):
        logits, cache = trep._decode(cache, {
            "tokens": torch.tensor([[toks[t]]], dtype=torch.int32),
            "cache_len": t})
        top = torch.topk(logits[0], 2).values
        if t >= len(toks) - 1:
            gaps.append(float(top[0] - top[1]))
            toks.append(int(logits[0].argmax()))
    assert min(gaps) > 1e-3


# -- the engine's own behaviour (mirror of tests/test_serving.py) -----------------

def test_generate_deterministic(replica):
    a = replica.generate([1, 2, 3], max_new_tokens=6)
    b = replica.generate([1, 2, 3], max_new_tokens=6)
    assert a == b and len(a) == 6
    assert all(0 <= t < 128 for t in a)
    assert replica.stats["requests"] >= 2


def test_batcher_matches_single(replica):
    cb = ContinuousBatcher(replica, max_slots=4)
    rids = [cb.add_request(p, max_new=5) for p in PROMPTS]
    cb.run_until_done()
    for p, rid in zip(PROMPTS, rids):
        assert cb.finished[rid] == replica.generate(p, max_new_tokens=5)


def test_batcher_midflight_admission(replica):
    cb = ContinuousBatcher(replica, max_slots=2)
    r1 = cb.add_request([1, 2, 3], max_new=6)
    for _ in range(4):
        cb.step()
    r2 = cb.add_request([4, 5], max_new=4)
    cb.run_until_done()
    assert cb.finished[r1] == replica.generate([1, 2, 3], max_new_tokens=6)
    assert cb.finished[r2] == replica.generate([4, 5], max_new_tokens=4)


def test_batcher_throttles_at_capacity(replica):
    cb = ContinuousBatcher(replica, max_slots=2)
    cb.add_request([1], max_new=4)
    cb.add_request([2], max_new=4)
    with pytest.raises(RuntimeError):
        cb.add_request([3], max_new=4)   # DP-level throttling boundary


def test_batcher_stops_at_max_seq():
    rep = Replica(TINY, max_seq=8, exec_cache=ExecutableCache(), device="cpu")
    cb = ContinuousBatcher(rep, max_slots=1)
    rid = cb.add_request([1, 2, 3], max_new=50)
    cb.run_until_done()
    # length reaches max_seq - 1 = 7 after 3 prompt + 4 generated... the
    # prompt's last step already yields a token: 7 steps, 5 tokens
    assert cb.steps == 7 and len(cb.finished[rid]) == 5


def test_sampling_modes():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    out = sample_token(logits)
    assert int(out[0]) == 1 and out.dtype == torch.int32      # greedy
    gen = torch.Generator().manual_seed(0)
    # near-uniform logits: 64 independent rows almost surely differ, so
    # this asserts per-row sampling rather than seed luck
    soft = torch.tensor([[0.0, 1.0, 0.5]])
    t = sample_token(soft.repeat(64, 1), gen, temperature=1.0)
    assert len(set(t.tolist())) > 1
    tk = sample_token(logits.repeat(16, 1), gen, temperature=1.0, top_k=1)
    assert set(tk.tolist()) == {1}                             # top-1 == greedy
    # the draw follows the distribution: P(token 1) = e^5 / (1 + e^5 + e)
    many = sample_token(logits.repeat(4000, 1), gen, temperature=1.0)
    share = float((many == 1).float().mean())
    assert abs(share - np.exp(5) / (1 + np.exp(5) + np.e)) < 0.02
    # same generator state, same draw
    a = sample_token(soft.repeat(8, 1), torch.Generator().manual_seed(7), 1.0)
    b = sample_token(soft.repeat(8, 1), torch.Generator().manual_seed(7), 1.0)
    assert torch.equal(a, b)


# -- the shared warm-state cache (mirror of tests/test_live.py:32-71) -------------

def test_second_replica_adds_zero_warmed_signatures():
    cache = ExecutableCache()
    shape = ShapeSpec("live", 64, 2, "decode")
    r1 = Replica(TINY, max_seq=64, exec_cache=cache, device="cpu")
    assert cache.warm(TINY, shape, run_cfg=r1.run_cfg, model=r1.model) > 0.0
    out1 = r1.generate([1, 2, 3], max_new_tokens=4)
    warmed = cache.compiled_executables()
    assert warmed == 1 and cache.misses == 1
    r2 = Replica(TINY, max_seq=64, exec_cache=cache, device="cpu")
    assert cache.warm(TINY, shape, run_cfg=r2.run_cfg, model=r2.model) == 0.0
    out2 = r2.generate([1, 2, 3], max_new_tokens=4)
    assert cache.compiled_executables() == warmed
    assert cache.hits >= 1 and r2.entry is r1.entry
    assert out1 == out2                       # same seed, same weights
    assert cache.stats() == {"entries": 1, "hits": cache.hits, "misses": 1,
                             "evictions": 0, "compiled_executables": 1}


def test_replicas_share_skeleton_not_state():
    cache = ExecutableCache()
    r1 = Replica(TINY, max_seq=64, rng_seed=0, exec_cache=cache, device="cpu")
    r2 = Replica(TINY, max_seq=64, rng_seed=1, exec_cache=cache, device="cpu")
    assert r1.entry.model is r2.entry.model          # one shared skeleton
    assert r1.entry.model.embed.device.type == "meta"   # which owns no storage
    assert r1.model is not r2.model                  # per-replica state
    assert not torch.equal(r1.params["embed"], r2.params["embed"])


def test_cache_capacity_evicts_lru():
    cache = ExecutableCache(capacity=1)
    cache.get(TINY)
    cache.get(TINY.reduced(n_layers=1, d_model=32, n_heads=2, d_ff=64,
                           vocab=64))
    assert len(cache) == 1 and cache.evictions == 1
    cache.get(TINY)                                   # evicted: a miss again
    assert cache.misses == 3 and cache.hits == 0


def test_warm_runs_a_shape_once():
    cache = ExecutableCache()
    shape = ShapeSpec("live", 64, 2, "decode")
    dt1 = cache.warm(TINY, shape, device="cpu")
    dt2 = cache.warm(TINY, shape, device="cpu")
    assert dt1 > 0.0 and dt2 == 0.0
    assert cache.warm(TINY, ShapeSpec("live", 64, 3, "decode"),
                      device="cpu") > 0.0
    assert cache.compiled_executables() == 2


def test_default_cache_is_process_global():
    fresh = reset_default_cache()
    assert default_cache() is fresh
    rep = Replica(TINY, max_seq=16, device="cpu")
    assert rep.exec_cache is fresh and len(fresh) == 1
    assert reset_default_cache() is not fresh
