"""The port's training path against the reference: ``loss_fn`` and its
gradients on every family, one AdamW step, the int8 codec, the data
streams, checkpoints in both directions, the MessagePack codec of the
manifest, and the kernels' refusal of inputs that require grad (ROADMAP
§C6). The mirrors of tests/test_train.py keep its names and its
tolerances (loss rtol 1e-5; params atol 1e-4, rtol 1e-3).

Weights and inputs are made with numpy (or drawn by the reference's init
and converted) and handed to both packages; everything runs on the CPU.
Whisper's loss and gradients are held in tests/test_torch_whisper.py,
which builds its pair once.
"""
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.data import ZipfLMStream as JZipf  # noqa: E402
from repro.train.optimizer import (adamw_init as jadamw_init,  # noqa: E402
                                   adamw_update as jadamw_update)
from repro_torch import convert  # noqa: E402
from repro_torch.configs import all_arch_names, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.train import checkpoint, msgpack_codec  # noqa: E402
from repro_torch.train.checkpoint import (latest_step,  # noqa: E402
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.compress import (compress_tree,  # noqa: E402
                                        decompress_tree, dequantize_int8,
                                        quantize_int8, roundtrip_tree)
from repro_torch.train.data import ZipfLMStream, random_tokens  # noqa: E402
from repro_torch.train.optimizer import (AdamWState, adamw_init,  # noqa: E402
                                         adamw_update)
from repro_torch.train.train_step import (make_eval_step,  # noqa: E402
                                          make_train_step)
from torch_port_util import (as_np, assert_grads_close, grads_of,  # noqa: E402
                             model_pair, torch_threads)

CFG = get_config("smollm-360m").reduced(n_layers=2, d_model=64, n_heads=4,
                                        d_ff=128, vocab=256)
RUN = RunConfig(q_chunk=16, kv_chunk=16, attn_impl="plain")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _setup(run_kw=None, seed=0):
    model = build_model(CFG, replace(RUN, **(run_kw or {})), device="cpu")
    model.init_params(torch.Generator().manual_seed(seed))
    step = make_train_step(model, lr=1e-3)
    return model, adamw_init(dict(model.named_parameters())), step


def _gen(i):
    return torch.Generator().manual_seed(i)


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


# -- the kernels refuse gradients (C6) -----------------------------------------

def _kernel_case(name):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    if name == "flash_attention":
        return flash_attention, "flash_attention", (rnd(1, 8, 2, 16),
                                                    rnd(1, 8, 1, 16),
                                                    rnd(1, 8, 1, 16)), {}
    if name == "decode_attention":
        return decode_attention, "decode_attention", (
            rnd(2, 1, 2, 16), rnd(2, 8, 1, 16), rnd(2, 8, 1, 16),
            torch.tensor([5, 8])), {}
    if name == "wkv6":
        return wkv6, "wkv6", (rnd(1, 8, 2, 4), rnd(1, 8, 2, 4),
                              rnd(1, 8, 2, 4),
                              torch.sigmoid(rnd(1, 8, 2, 4)) * 0.5 + 0.45,
                              rnd(2, 4)), {"chunk": 4}
    return ssd, "ssd", (rnd(1, 8, 2, 4), torch.rand((1, 8, 2), generator=g),
                        -torch.rand((2,), generator=g) - 0.5,
                        rnd(1, 8, 2, 3), rnd(1, 8, 2, 3), rnd(2)), {"chunk": 4}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "ssd"])
def test_kernel_wrapper_refuses_an_input_that_requires_grad(name):
    """On a CPU tensor as on a CUDA one (the guard stands before the device
    branch): no quiet switch to the plain version. Without grad mode the
    same call runs; ``ops`` with impl="plain" differentiates."""
    fn, op, args, kw = _kernel_case(name)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match='attn_impl="plain"'):
        fn(*args, **kw)
    with pytest.raises(RuntimeError, match="no backward"):
        getattr(ops, op)(*args, impl="kernel", **kw)
    with torch.no_grad():
        fn(*args, **kw)
    out = getattr(ops, op)(*args, impl="plain", **kw)
    out = out[0] if isinstance(out, tuple) else out
    out.sum().backward()
    assert args[0].grad is not None and bool(torch.isfinite(
        args[0].grad).all())


def test_a_model_on_the_kernels_refuses_to_train():
    model, opt, _ = _setup()
    model.run = replace(model.run, attn_impl="kernel")
    step = make_train_step(model, lr=1e-3)
    batch = random_tokens(0, 2, 16, 256, device="cpu")
    with pytest.raises(RuntimeError, match="flash_attention"):
        step(opt, batch, _gen(0))


# -- loss_fn and gradients on every family ---------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("smollm-360m", {}), ("arctic-480b", {}), ("rwkv6-7b", {}),
    ("zamba2-2.7b", {}), ("qwen2-vl-72b", {})])
def test_loss_and_grads_match_jax(name, kw):
    """jax.value_and_grad of the reference's loss_fn against the port's
    loss_fn and torch.autograd on converted weights: the dense, MoE (no
    token dropped at this capacity), RWKV6 (seq_chunk 8), Zamba2 and M-RoPE
    families. Loss 2e-4; gradients atol 1e-4, rtol 1e-3."""
    mj, pj, mt = model_pair(name, **kw)
    toks = np.random.default_rng(0).integers(
        0, mt.cfg.vocab, (2, 17)).astype(np.int32)
    lj, gj = jax.value_and_grad(mj.loss_fn)(pj, {
        "tokens": jnp.asarray(toks[:, :-1]),
        "labels": jnp.asarray(toks[:, 1:])})
    loss, gt = grads_of(mt, {"tokens": torch.from_numpy(toks[:, :-1]),
                             "labels": torch.from_numpy(toks[:, 1:])})
    np.testing.assert_allclose(float(loss), float(lj), atol=2e-4, rtol=2e-4)
    assert_grads_close(gt, convert.flatten_tree(
        jax.tree.map(np.asarray, gj)))


def test_loss_fn_is_the_reference_arithmetic():
    """fp32 logsumexp - gold, mean; on a model without grads as well."""
    model, _, _ = _setup()
    batch = random_tokens(3, 2, 16, 256, device="cpu")
    with torch.no_grad():
        logits = model.forward(batch).double()
        want = torch.mean(torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, batch["labels"].long()[..., None])[..., 0])
        got = make_eval_step(model)(batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- AdamW -------------------------------------------------------------------------

def test_adamw_update_matches_jax():
    """Two steps from the same parameters and gradients, the second with
    gradients large enough that the global-norm clip acts: parameters,
    moments, step and grad norm within 1e-5."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (32, 8), "layers.wq": (2, 8, 8), "final_norm": (8,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pj = convert.unflatten_tree({k: jnp.asarray(v) for k, v in params.items()})
    st, sj = adamw_init(pt), jadamw_init(pj)
    for scale in (0.01, 10.0):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        pt, st, nt = adamw_update({k: torch.from_numpy(v)
                                   for k, v in grads.items()}, st, pt,
                                  lr=1e-2)
        pj, sj, nj = jadamw_update(convert.unflatten_tree(
            {k: jnp.asarray(v) for k, v in grads.items()}), sj, pj, lr=1e-2)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5)
        assert int(st.step) == int(sj.step)
        for tree_t, tree_j in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
            flat = convert.flatten_tree(jax.tree.map(np.asarray, tree_j))
            for k, v in tree_t.items():
                np.testing.assert_allclose(as_np(v), flat[k], atol=1e-5,
                                           rtol=1e-5, err_msg=k)


def test_adamw_keeps_bf16_parameters_bf16():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.mu["w"].dtype == torch.float32
    p2, st, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                             p, lr=0.5)
    assert p2["w"] is p["w"] and p["w"].dtype == torch.bfloat16
    assert float(p["w"][0]) < 1.0


# -- mirrors of tests/test_train.py --------------------------------------------------

def test_loss_decreases():
    model, opt, step = _setup()
    stream = ZipfLMStream(vocab=256, seq=32, batch=8, seed=3, device="cpu")
    losses = []
    for i in range(15):
        opt, m = step(opt, stream.batch_at(i), _gen(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert not any(np.isnan(losses))
    assert int(m["step"]) == 15


def test_grad_accum_equivalence():
    """accum=2 over a batch == single step over the same batch."""
    m1, o1, step1 = _setup()
    m2, o2, step2 = _setup({"grad_accum": 2})
    batch = random_tokens(0, 8, 32, 256, device="cpu")
    _, r1 = step1(o1, batch, _gen(0))
    _, r2 = step2(o2, batch, _gen(0))
    np.testing.assert_allclose(float(r1["loss"]), float(r2["loss"]),
                               rtol=1e-5)
    for (k, a), b in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(as_np(a), as_np(b), atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def test_grad_accum_needs_equal_microbatches():
    _, opt, step = _setup({"grad_accum": 3})
    with pytest.raises(ValueError, match="microbatches"):
        step(opt, random_tokens(0, 8, 16, 256, device="cpu"), _gen(0))


def test_int8_quantizer_unbiased():
    x = torch.randn(4096, generator=_gen(0)) * 3.0
    acc = torch.zeros_like(x)
    for i in range(64):
        q, s = quantize_int8(x, _gen(100 + i))
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
        deq = dequantize_int8(q, s)
        assert float((deq - x).abs().max()) <= float(s) * (1 + 1e-6)
        acc = acc + deq
    mean = acc / 64
    scale = float(x.abs().max()) / 127.0
    assert float((mean - x).abs().max()) < scale * 1.2


def test_roundtrip_tree_streams():
    """Per-leaf streams: one seed drawn from the caller's generator, so the
    same generator state gives the same tree and the next draw another;
    leaves keep their dtype."""
    tree = {"a": torch.randn(256, generator=_gen(1)),
            "b": torch.randn(256, generator=_gen(2)).to(torch.bfloat16)}
    g = _gen(7)
    r1 = roundtrip_tree(tree, g)
    r2 = roundtrip_tree(tree, g)
    r3 = roundtrip_tree(tree, _gen(7))
    assert r1["b"].dtype == torch.bfloat16
    assert all(torch.equal(r1[k], r3[k]) for k in tree)
    assert not torch.equal(r1["a"], r2["a"])
    # the int8 buffers themselves: the same codes and scales
    ctree = compress_tree(tree, _gen(7))
    assert all(q.dtype == torch.int8 and s.dtype == torch.float32
               for q, s in ctree.values())
    back = decompress_tree(ctree)
    assert torch.equal(back["a"], r3["a"]) and back["b"].dtype == torch.float32
    assert torch.equal(back["b"].to(torch.bfloat16), r3["b"])


def test_compressed_training_still_learns():
    model, opt, step = _setup({"grad_compress": True})
    stream = ZipfLMStream(vocab=256, seq=32, batch=8, seed=5, device="cpu")
    losses = []
    for i in range(15):
        opt, m = step(opt, stream.batch_at(i), _gen(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_checkpoint_resume_bitexact(tmp_path):
    """save -> restore -> continue == continuous run (fault tolerance)."""
    model, opt, step = _setup()
    stream = ZipfLMStream(vocab=256, seq=32, batch=8, seed=7, device="cpu")
    for i in range(4):
        opt, _ = step(opt, stream.batch_at(i), _gen(i))
    params = dict(model.named_parameters())
    save_checkpoint(str(tmp_path), 4, {"params": params, "opt": opt})
    for i in range(4, 8):
        opt, _ = step(opt, stream.batch_at(i), _gen(i))
    p_cont = _params(model)

    model2, opt2, step2 = _setup(seed=99)           # other weights entirely
    like = {"params": dict(model2.named_parameters()), "opt": opt2}
    restored, step_n = restore_checkpoint(str(tmp_path), None, like)
    assert step_n == 4 and isinstance(restored["opt"], AdamWState)
    with torch.no_grad():
        for k, p in model2.named_parameters():
            p.copy_(restored["params"][k])
    opt2 = restored["opt"]
    for i in range(4, 8):
        opt2, _ = step2(opt2, stream.batch_at(i), _gen(i))
    for k, p in model2.named_parameters():
        assert torch.equal(p, p_cont[k]), k


def test_checkpoint_async_and_latest(tmp_path):
    """The async writer saves the tree as it was at the call, though the
    caller updates it in place while the files are written."""
    model, _, _ = _setup()
    params = dict(model.named_parameters())
    before = _params(model)
    t = save_checkpoint(str(tmp_path), 1, {"p": params}, async_save=True)
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = restore_checkpoint(str(tmp_path), 1, {"p": params})
    assert all(torch.equal(got["p"][k], before[k]) for k in params)
    save_checkpoint(str(tmp_path), 5, {"p": params})
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000005"]


def test_restore_onto_another_device(tmp_path):
    """The single-device counterpart of elastic restore: leaves land on the
    device asked for, whatever the device of ``like``."""
    model, _, _ = _setup()
    save_checkpoint(str(tmp_path), 2, {"params": dict(
        model.named_parameters())})
    skeleton = build_model(CFG, RUN, device="meta")
    restored, _ = restore_checkpoint(
        str(tmp_path), 2, {"params": dict(skeleton.named_parameters())},
        device="cpu")
    for k, p in model.named_parameters():
        assert restored["params"][k].device.type == "cpu"
        assert torch.equal(restored["params"][k], p), k


def test_data_stream_determinism():
    s1 = ZipfLMStream(vocab=128, seq=16, batch=4, seed=9, device="cpu")
    s2 = ZipfLMStream(vocab=128, seq=16, batch=4, seed=9, device="cpu")
    b1, b2 = s1.batch_at(17), s2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])


@pytest.mark.parametrize("step", [0, 17])
def test_zipf_stream_equals_the_reference(step):
    ours = ZipfLMStream(vocab=300, seq=24, batch=3, seed=11,
                        device="cpu").batch_at(step)
    ref = JZipf(vocab=300, seq=24, batch=3, seed=11).batch_at(step)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == torch.int32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_random_tokens_properties():
    a = random_tokens(3, 4, 16, 100, seed=1, device="cpu")
    b = random_tokens(3, 4, 16, 100, seed=1, device="cpu")
    c = random_tokens(4, 4, 16, 100, seed=1, device="cpu")
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])


@pytest.mark.parametrize("arch", all_arch_names())
def test_forward_and_train_step(arch):
    """tests/test_models_smoke.py's test of the same name, on the port."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, RunConfig(q_chunk=16, kv_chunk=16, seq_chunk=16,
                                       attn_impl="plain"), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((2, 32), dtype=torch.int32),
             "labels": torch.ones((2, 32), dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.full((2, cfg.enc_dec.encoder_seq,
                                      cfg.d_model), 0.01)
    with torch.no_grad():
        logits = model.forward(batch)
    assert logits.shape == (2, 32, cfg.vocab)
    assert not bool(torch.isnan(logits).any())
    before = _params(model)
    step = make_train_step(model, lr=1e-3)
    _, m = step(adamw_init(dict(model.named_parameters())), batch, _gen(1))
    assert not bool(torch.isnan(m["loss"]))
    assert float(m["grad_norm"]) > 0
    assert any(not torch.allclose(p, before[k])
               for k, p in model.named_parameters())


# -- checkpoints across the two packages -----------------------------------------------

def _files(d):
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as fh:
            out[n] = fh.read()
    return out


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path, monkeypatch):
    """A reference train state (params and AdamW state after one step) saved
    by repro.train.checkpoint restores here bit for bit; saved again here,
    the files (manifest included) are byte-equal to the reference's, and
    the reference restores them. Chunks forced small on both sides."""
    monkeypatch.setattr(jckpt, "_CHUNK_BYTES", 4096)
    monkeypatch.setattr(checkpoint, "_CHUNK_BYTES", 4096)
    mj, pj, mt = model_pair("smollm-360m")
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), pj)
    pj, oj, _ = jadamw_update(grads, jadamw_init(pj), pj)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 3, {"params": pj, "opt": oj})

    params = dict(mt.named_parameters())
    restored, at = restore_checkpoint(str(tmp_path / "jax"), None,
                                      {"params": params,
                                       "opt": adamw_init(params)})
    assert at == 3
    assert restored["opt"].step.dtype == torch.int32
    assert int(restored["opt"].step) == 1
    for tree_t, tree_j in ((restored["params"], pj),
                           (restored["opt"].mu, oj.mu),
                           (restored["opt"].nu, oj.nu)):
        flat = convert.flatten_tree(jax.tree.map(np.asarray, tree_j))
        assert set(flat) == set(tree_t)
        for k, v in tree_t.items():
            np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)

    save_checkpoint(str(tmp_path / "port"), 3, restored)
    a = _files(tmp_path / "jax" / "step_00000003")
    b = _files(tmp_path / "port" / "step_00000003")
    assert any(".0001.npy" in n for n in a)       # chunked leaves
    assert a.keys() == b.keys()
    for n in a:
        assert a[n] == b[n], n
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), 3,
                                       {"params": pj, "opt": oj})
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": pj, "opt": oj})):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    """bf16 travels as its two raw bytes under numpy's ``<V2`` descriptor,
    as jax arrays are saved: the port reads the reference's files bit for
    bit and writes byte-equal ones."""
    w = (np.random.default_rng(0).standard_normal((5, 7)) * 3).astype(
        np.float32)
    jtree = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(w[0])}
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jtree)
    like = {"w": torch.empty(0), "b": torch.empty(0)}
    got, _ = restore_checkpoint(str(tmp_path / "jax"), 1, like)
    assert got["w"].dtype == torch.bfloat16
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    save_checkpoint(str(tmp_path / "port"), 1, got)
    assert _files(tmp_path / "jax" / "step_00000001") == \
        _files(tmp_path / "port" / "step_00000001")
    # the reference's own restore cannot cast ``V2`` to bfloat16 (ROADMAP
    # §C8); the port reads the same files above
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore_checkpoint(str(tmp_path / "jax"), 1, jtree)


def test_checkpoint_module_carries_its_own_msgpack():
    src = open(checkpoint.__file__).read() + open(msgpack_codec.__file__).read()
    assert "import msgpack\n" not in src and "from msgpack" not in src


# -- the manifest's MessagePack codec -----------------------------------------------

_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.5, -1e300, 3.0, True, False, None, "", "x" * 31, "y" * 32,
    "z" * 255, "w" * 256, "v" * 70000, "päth/ünïcode", [], list(range(15)),
    list(range(16)), list(range(70000)), (1, "a"), {}, {str(i): i for i in
                                                        range(15)},
    {str(i): i for i in range(16)}, {"nested": {"a": [1, {"b": None}]}},
]


@pytest.mark.parametrize("value", _VALUES, ids=range(len(_VALUES)))
def test_msgpack_codec_is_byte_equal_to_msgpack(value):
    want = msgpack.packb(value)
    assert msgpack_codec.packb(value) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want)


def test_msgpack_codec_reads_the_reference_manifests(tmp_path):
    _, pj, _ = model_pair("arctic-480b")
    jckpt.save_checkpoint(str(tmp_path), 12345678, {"params": pj,
                                                    "opt": jadamw_init(pj)})
    with open(tmp_path / "step_12345678" / "manifest.msgpack", "rb") as fh:
        raw = fh.read()
    man = msgpack_codec.unpackb(raw)
    assert man == msgpack.unpackb(raw)
    assert msgpack_codec.packb(man) == raw
    assert man["step"] == 12345678 and len(man["leaves"]) > 20
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(raw + b"\x00")
