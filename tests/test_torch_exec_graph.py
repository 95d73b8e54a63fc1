"""The captured decode executable (``serving/exec_cache.DecodeExecutable``)
in its CPU form.

On a CUDA device a replica decodes by replaying a CUDA graph of
``decode_step``, the counterpart of the reference's ``jax.jit``; on the CPU
the same object runs the step eagerly on the same static buffers (tokens,
lengths, the cache it owns, the logits it returns). What is held here is
that form: its logits equal ``decode_step``'s, a replica's greedy tokens
through it equal the JAX ``Replica``'s, its cache is re-zeroed per request,
one-length models still refuse differing lengths, the decode bodies read
nothing on the host on its static inputs (what a capture needs), a replay
adds the launches its capture counted, and each user of ``new_cache`` (a
batcher, ``generate``) decodes on a cache of its own, as the reference's
fresh cache per call. The graph itself is built and
replayed on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving.engine import Replica as JReplica  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, Replica  # noqa: E402
from repro_torch.serving.exec_cache import (DecodeExecutable,  # noqa: E402
                                            ExecutableCache)
from torch_port_util import (jax_tree_to_numpy, no_host_reads,  # noqa: E402
                             reduced_pair)

KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512)
FAMILIES = {"smollm-360m": KW, "rwkv6-7b": KW, "arctic-480b": KW,
            "zamba2-2.7b": KW, "qwen2-vl-72b": KW}
PROMPTS = [[3, 1, 4, 1, 5], [9], [2, 7]]


def _model(name, seed=0):
    cfg = get_config(name).reduced(**FAMILIES[name])
    return build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed))


def _exe(model, batch=3, seq=32):
    """A warmed executable of ``model`` (which the caller keeps alive: the
    executable holds it weakly)."""
    exe = DecodeExecutable(model, ShapeSpec("t", seq, batch, "decode"))
    exe.warm()
    return exe


@pytest.fixture(scope="module")
def jax_pairs():
    """(jax replica, torch replica) on the same weights, per family."""
    out = {}
    for name in ("smollm-360m", "rwkv6-7b", "arctic-480b", "zamba2-2.7b"):
        cj, ct = reduced_pair(name, **FAMILIES[name])
        jrep = JReplica(cj, max_seq=64)
        trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(),
                       device="cpu")
        convert.load_params(trep.model, jax_tree_to_numpy(jrep.params))
        out[name] = (jrep, trep)
    return out


# -- the eager form against decode_step -----------------------------------------

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_equal_decode_step(name):
    """Step by step from a zeroed cache: the executable's logits equal
    ``decode_step``'s on a cache of its own, bit for bit."""
    model = _model(name)
    exe = _exe(model)
    cache = model.init_cache(ShapeSpec("t", 32, 3, "decode"), batch=3)
    rng = np.random.default_rng(0)
    one = name == "zamba2-2.7b"
    with torch.inference_mode():
        for t in range(5):
            tok = rng.integers(0, 512, (3, 1)).astype(np.int32)
            lens = np.full(3, t, np.int32) if one else \
                np.array([t, max(t - 1, 0), 2 * t], np.int32)
            got = exe(tok, lens).clone()
            want, cache = model.decode_step(cache, {
                "tokens": torch.from_numpy(tok),
                "cache_len": torch.from_numpy(lens)})
            assert torch.equal(got, want), t
    for k in cache:
        assert torch.equal(exe.cache[k], cache[k]), k
    assert exe.eager_steps == 5 and exe.graph is None


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_warm_leaves_a_zeroed_cache(name):
    exe = _exe(_model(name))
    assert exe.warm_steps == 2
    assert all(not t.any() for t in exe.cache.values())


# -- greedy tokens against the JAX Replica ---------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", "rwkv6-7b", "arctic-480b",
                                  "zamba2-2.7b"])
def test_generate_tokens_equal_jax(jax_pairs, name):
    jrep, trep = jax_pairs[name]
    for prompt in PROMPTS:
        assert trep.generate(prompt, max_new_tokens=6) == \
            jrep.generate(prompt, max_new_tokens=6), prompt
    exe = trep.executable(1)
    assert exe.eager_steps > 0 and exe.warm_steps == 2


@pytest.mark.parametrize("name", ["smollm-360m", "rwkv6-7b", "arctic-480b"])
def test_batcher_tokens_equal_jax(jax_pairs, name):
    """The batcher's cache is its executable's; each request's tokens equal
    the JAX replica's generate of its prompt alone."""
    jrep, trep = jax_pairs[name]
    cb = ContinuousBatcher(trep, max_slots=2)
    assert cb.cache is trep.executable(2).cache
    rids = [cb.add_request(p, max_new=5) for p in PROMPTS[:2]]
    cb.run_until_done()
    rids.append(cb.add_request(PROMPTS[2], max_new=5))   # a reused slot
    cb.run_until_done()
    for p, rid in zip(PROMPTS, rids):
        assert cb.finished[rid] == jrep.generate(p, max_new_tokens=5), p


# -- the cache the executable owns ----------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b"])
def test_generate_twice_rezeroes_the_cache(name):
    """The recurrent state would carry over into the next request if the
    batch-1 cache were not zeroed at its start."""
    rep = Replica(get_config(name).reduced(**FAMILIES[name]), max_seq=32,
                  exec_cache=ExecutableCache(), device="cpu")
    a = rep.generate([5, 6, 7], max_new_tokens=5)
    assert any(t.any() for t in rep.executable(1).cache.values())
    assert rep.generate([5, 6, 7], max_new_tokens=5) == a


def test_decode_takes_only_the_owned_cache():
    rep = Replica(get_config("smollm-360m").reduced(**KW), max_seq=32,
                  exec_cache=ExecutableCache(), device="cpu")
    own = rep.new_cache(1)
    batch = {"tokens": torch.tensor([[1]], dtype=torch.int32),
             "cache_len": 0}
    logits, cache = rep._decode(own, batch)
    assert cache is own and logits.shape == (1, 512)
    with pytest.raises(ValueError, match="new_cache"):
        rep._decode(rep.model.init_cache(ShapeSpec("t", 32, 1, "decode"),
                                         batch=1), batch)


# -- each user of new_cache owns its cache (the reference builds one a call) ----

C12_PROMPT = [3, 1, 4, 1, 5]


@pytest.fixture(scope="module")
def smollm_jax():
    """The JAX replica and its weights as numpy, for fresh port replicas."""
    cj, ct = reduced_pair("smollm-360m", **KW)
    jrep = JReplica(cj, max_seq=64)
    return jrep, ct, jax_tree_to_numpy(jrep.params)


def _interfered(rep, batcher, case):
    """A one-slot batcher's request, with another user of the replica
    coming in after 4 steps: nothing, a ``generate``, or a second batcher of
    the same batch size that serves a request of its own."""
    cb = batcher(rep, max_slots=1)
    rid = cb.add_request(C12_PROMPT, max_new=6)
    for _ in range(4):
        cb.step()
    if case == "after-generate":
        rep.generate([9, 9], 2)
    elif case == "second-batcher":
        other = batcher(rep, max_slots=1)
        other.add_request([7, 7], max_new=2)
        other.run_until_done()
    cb.run_until_done()
    return cb.finished[rid]


@pytest.mark.parametrize("case", ["alone", "after-generate",
                                  "second-batcher"])
def test_each_new_cache_is_its_users_own(smollm_jax, case):
    jrep, ct, params = smollm_jax
    trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(),
                   device="cpu")
    convert.load_params(trep.model, params)
    want = _interfered(jrep, JBatcher, case)
    assert want == jrep.generate(C12_PROMPT, max_new_tokens=6)
    assert _interfered(trep, ContinuousBatcher, case) == want


def test_second_new_cache_captures_a_graph_not_a_signature(monkeypatch):
    """On a replica whose warm-ups fake a capture, a second cache of one
    signature is a second executable with a graph of its own, and no new
    signature; ``generate``'s batch-1 executable is neither."""
    warm = DecodeExecutable.warm

    def fake_capture(self, steps=2):
        warm(self, steps)
        self.graph = _FakeGraph(self)

    monkeypatch.setattr(DecodeExecutable, "warm", fake_capture)
    cache = ExecutableCache()
    rep = Replica(get_config("smollm-360m").reduced(**KW), max_seq=32,
                  exec_cache=cache, device="cpu")
    first = rep.new_cache(2)
    assert first is rep.executable(2).cache
    assert cache.stats()["captured_graphs"] == 1
    assert cache.stats()["compiled_executables"] == 1
    second = rep.new_cache(2)
    assert second is not first and second is rep._executables[2][1].cache
    assert cache.stats()["captured_graphs"] == 2
    assert cache.stats()["compiled_executables"] == 1
    cache_1 = rep.new_cache(1)
    assert cache_1 is rep.executable(1).cache
    assert rep._take(1).cache is not cache_1       # generate's own
    assert cache.stats()["captured_graphs"] == 4
    assert cache.stats()["compiled_executables"] == 2


def test_zamba2_differing_lengths_raise_through_the_executable():
    model = _model("zamba2-2.7b")
    exe = _exe(model, batch=2)
    exe(np.zeros((2, 1), np.int32), [3, 3])
    with pytest.raises(ValueError, match="one cache_len"):
        exe(np.zeros((2, 1), np.int32), [3, 4])


# -- no host reads in the step body ---------------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", "qwen2-vl-72b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_step_body_reads_nothing_on_the_host(name):
    """The body a graph captures, on the executable's static inputs. (MoE
    is left out here: its plain grouped GEMM, which the CPU takes, reads
    the group sizes; on the card its kernel does not, and the capture's
    sync-debug step checks it.)"""
    model = _model(name)
    exe = _exe(model)
    exe(np.ones((3, 1), np.int32), 4)
    with torch.inference_mode(), no_host_reads():
        logits = exe._step()
    assert logits.shape == (3, 512)
    # the guard catches what it is for: a length read on the host, as
    # Zamba2's step makes when its lengths were not checked before
    with pytest.raises(AssertionError, match="host"), \
            torch.inference_mode(), no_host_reads():
        if name == "zamba2-2.7b":
            exe.model.decode_step(exe.cache, {"tokens": exe.tokens,
                                              "cache_len": exe.cache_len})
        else:
            exe.cache_len[0].item()


# -- the replay form's accounting -----------------------------------------------

class _FakeGraph:
    """Stands in for a captured graph: a replay writes the logits from the
    staged tokens, so the test sees what was staged."""

    def __init__(self, exe):
        self.exe = exe

    def replay(self):
        self.exe.logits.copy_(self.exe.tokens.float().expand_as(
            self.exe.logits))


def test_replay_adds_the_captured_launch_counts():
    model = _model("smollm-360m")
    exe = _exe(model, batch=2)
    exe(np.zeros((2, 1), np.int32), 0)
    exe.graph, exe.replay_counts = _FakeGraph(exe), {"decode_attention": 2,
                                                     "grouped_matmul": 6}
    before = ops.launch_counts()
    out = exe(np.array([[7], [9]], np.int32), [1, 2])
    out = exe(np.array([[5], [6]], np.int32), [2, 3])
    moved = ops.launch_delta(before)
    assert moved == {"decode_attention": 4, "grouped_matmul": 12}
    assert exe.replays == 2 and exe.cache_len.tolist() == [2, 3]
    assert out[:, 0].tolist() == [5.0, 6.0]
    ops.add_launches(moved, times=-1)
    assert ops.launch_counts() == before


def test_stats_count_captured_graphs():
    cache = ExecutableCache()
    rep = Replica(get_config("smollm-360m").reduced(**KW), max_seq=32,
                  exec_cache=cache, device="cpu")
    exe = rep.executable(2)
    assert cache.stats()["captured_graphs"] == 0       # eager on the CPU
    exe.graph = _FakeGraph(exe)
    assert cache.stats()["captured_graphs"] == 1
    assert cache.stats()["compiled_executables"] == 1
    del rep, exe
    import gc
    gc.collect()
    # the replica's executables go with it
    assert cache.stats()["captured_graphs"] == 0
