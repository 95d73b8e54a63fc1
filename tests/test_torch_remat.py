"""Per-layer activation checkpointing (``models/remat.py``), the
counterpart of the reference's ``jax.checkpoint`` under
``RunConfig.remat``: on the CPU at reduced sizes, for the dense, MoE, vlm,
RWKV6, Zamba2 and Whisper families.

  * the loss and every gradient with remat on equal remat off bit for bit
    (``full``, and ``dots`` on ``DecoderLM``);
  * with remat on they match ``jax.grad`` of the reference with remat on,
    on the same weights (``convert``): loss 2e-4, gradients atol 1e-4 /
    rtol 1e-3 (``assert_grads_close``);
  * nothing is checkpointed under ``torch.no_grad()`` or in
    ``decode_step``;
  * ``dots`` keeps the ``mm`` / ``addmm`` outputs and nothing else, so a
    ``dots`` layer keeps more than a ``full`` one and less than none;
  * the dry run: a small train cell's temp bytes fall with remat on, and
    on a fake (1, 2) mesh the recompute runs a layer's collectives again,
    as far as the backward needs them, logged from a backward on a thread
    of its own.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.steps import default_run_config  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402

from torch_port_util import (SRC, assert_grads_close, fake_mesh,  # noqa: E402
                             jax_tree_to_numpy, reduced_pair, torch_threads)

KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
FAMILIES = {"smollm-360m": KW, "arctic-480b": KW, "qwen2-vl-72b": KW,
            "rwkv6-7b": KW, "zamba2-2.7b": dict(KW, n_layers=4),
            "whisper-small": {}}
DECODER_LM = ("smollm-360m", "arctic-480b", "qwen2-vl-72b")
CASES = [(n, "full") for n in FAMILIES] + [(n, "dots") for n in DECODER_LM]
RUN = dict(attn_impl="plain", q_chunk=8, kv_chunk=8, seq_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _batch(cfg, enc_seq=None, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if enc_seq is not None:
        out["frames"] = (rng.standard_normal((2, enc_seq, cfg.d_model))
                         * 0.5).astype(np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """One port model a family, drawn from seed 0, gradients on."""
    out = {}
    for name, kw in FAMILIES.items():
        cfg = get_config(name).reduced(**kw)
        m = build_model(cfg, RunConfig(**RUN), device="cpu")
        m.init_params(torch.Generator().manual_seed(0))
        out[name] = m.requires_grad_(True)
    return out


def _loss_and_grads(model, batch, **run):
    model.run = dataclasses.replace(model.run, **run)
    params = dict(model.named_parameters())
    loss = model.loss_fn(batch)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


@pytest.mark.parametrize("name,policy", CASES)
def test_remat_equals_no_remat_bit_for_bit(models, name, policy):
    model = models[name]
    batch = _torch_batch(_batch(model.cfg, getattr(model, "enc_seq", None)))
    l0, g0 = _loss_and_grads(model, batch, remat=False)
    l1, g1 = _loss_and_grads(model, batch, remat=True, remat_policy=policy)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# -- against the reference's jax.grad with remat on -------------------------------

@pytest.fixture(scope="module")
def jax_pairs():
    """(jax model, jax params, port model) per (family, policy), remat on
    in both, the same weights: the reference's draw, carried over. Whisper
    takes the port's per-layer fan-in draw, carried the other way: at the
    reference's init its attention rows are one-hot (ROADMAP §C9), and
    fp32 round-off then moves the tied embedding's gradient by ~1e-3 of
    its largest entry between the packages on one of the two batches
    tried, with remat on or off in either (ROADMAP §C13; the tests after
    this one hold that case)."""
    out = {}
    for name, policy in CASES:
        cj, ct = reduced_pair(name, **FAMILIES[name])
        mj = jbuild(cj, JRun(q_chunk=8, kv_chunk=8, seq_chunk=8, remat=True,
                             remat_policy=policy))
        mt = build_model(ct, RunConfig(**RUN, remat=True,
                                       remat_policy=policy), device="cpu")
        if name == "whisper-small":
            mt.init_params(torch.Generator().manual_seed(0),
                           layer_fan_in=True)
            pj = jax.tree.map(jnp.asarray,
                              convert.to_numpy_tree(mt.state_dict()))
        else:
            pj = mj.init_params(jax.random.PRNGKey(0))
            convert.load_params(mt, jax_tree_to_numpy(pj))
        out[name, policy] = (mj, pj, mt.requires_grad_(True))
    return out


@pytest.mark.parametrize("name,policy", CASES)
def test_remat_matches_jax_grad(jax_pairs, name, policy):
    mj, pj, mt = jax_pairs[name, policy]
    b = _batch(mt.cfg, getattr(mt, "enc_seq", None), seed=1)
    lj, gj = jax.value_and_grad(mj.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in b.items()})
    params = dict(mt.named_parameters())
    loss = mt.loss_fn(_torch_batch(b))
    gt = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(lj), atol=2e-4,
                               rtol=2e-4)
    assert_grads_close(gt, convert.flatten_tree(jax.tree.map(np.asarray, gj)))


# -- Whisper at the reference's own init (ROADMAP §C13) ------------------------------

@pytest.fixture(scope="module")
def whisper_reference_init():
    """Reduced Whisper on the reference's draw (``PRNGKey(0)``) carried to
    the port, remat on in both, and the reference's gradients at batches 0
    and 1 (``_batch``'s seed), on its weights and on its weights one ulp up."""
    cj, ct = reduced_pair("whisper-small")
    mj = jbuild(cj, JRun(q_chunk=8, kv_chunk=8, seq_chunk=8, remat=True))
    pj = mj.init_params(jax.random.PRNGKey(0))
    mt = build_model(ct, RunConfig(**RUN, remat=True), device="cpu")
    convert.load_params(mt, jax_tree_to_numpy(pj))
    up = jax.tree.map(lambda x: jnp.nextafter(x, jnp.inf), pj)
    grads = {}
    for seed in (0, 1):
        b = _batch(ct, mt.enc_seq, seed=seed)
        for name, p in (("ref", pj), ("ref_ulp", up)):
            g = jax.grad(mj.loss_fn)(
                p, {k: jnp.asarray(v) for k, v in b.items()})
            grads[name, seed] = convert.flatten_tree(
                jax.tree.map(np.asarray, g))
    return mt.requires_grad_(True), grads


def _port_grads(mt, seed):
    params = dict(mt.named_parameters())
    loss = mt.loss_fn(_torch_batch(_batch(mt.cfg, mt.enc_seq, seed=seed)))
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def _largest_gap(got, want):
    """The largest difference over the leaves, each in units of its
    largest reference entry where that exceeds 1 (``assert_grads_close``'s
    atol)."""
    return max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(w, np.float64)).max())
               / max(1.0, float(np.abs(w).max())) for k, w in want.items())


def test_whisper_at_the_reference_init_matches_jax_grad(
        whisper_reference_init):
    """Batch 0 at the reference's init: within the tolerances."""
    mt, grads = whisper_reference_init
    assert_grads_close(_port_grads(mt, 0), grads["ref", 0])


def test_whisper_reference_init_gap_is_the_references_own_round_off(
        whisper_reference_init):
    """Batch 1 at the reference's init leaves ``assert_grads_close``'s atol
    in ``dec_pos`` and the tied embedding (1.3e-3 of their largest entry).
    The witness that this is round-off the one-hot attention rows amplify,
    and no fault of the port: the reference's own gradients move by as
    much when each of its weights moves one ulp (9.4e-4), and the port
    stays within twice that."""
    mt, grads = whisper_reference_init
    gap = _largest_gap(_port_grads(mt, 1), grads["ref", 1])
    own = _largest_gap(grads["ref_ulp", 1], grads["ref", 1])
    assert gap <= 2 * own, (gap, own)


# -- where nothing is checkpointed --------------------------------------------------

@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the layers ``remat.layer`` hands to ``checkpoint``."""
    calls = []
    real = remat.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(remat, "checkpoint", spy)
    return calls


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_nothing_is_checkpointed_without_grad_or_in_decode(models,
                                                           checkpoints, name):
    model = models[name]
    model.run = dataclasses.replace(model.run, remat=True,
                                    remat_policy="full")
    cfg = model.cfg
    batch = _torch_batch(_batch(cfg, getattr(model, "enc_seq", None)))
    model.loss_fn(batch)
    layers = cfg.n_layers
    if name == "zamba2-2.7b":       # the shared block is one more a group
        layers += cfg.n_layers // cfg.ssm.attn_every
    assert len(checkpoints) == layers
    del checkpoints[:]
    with torch.no_grad():
        model.loss_fn(batch)
    with torch.inference_mode():
        model.loss_fn(batch)
    # decode with gradients recorded: a cache is passed, nothing checkpoints
    cache = model.init_cache(ShapeSpec("d", 32, 2, "decode"))
    if name == "whisper-small":
        with torch.no_grad():
            model.prefill_cross(batch["frames"], cache)
    model.decode_step(cache, {"tokens": batch["tokens"][:, :1],
                              "cache_len": torch.tensor(0)})
    assert checkpoints == []


# -- what "dots" keeps --------------------------------------------------------------

def test_dots_keeps_the_products_and_nothing_else(monkeypatch):
    """The tensors a forward keeps for the backward, counted through
    ``saved_tensors_hooks`` (what autograd saves outside a checkpoint) plus
    what the selective policy keeps inside one: every op ``dots`` keeps is
    ``mm`` or ``addmm``, and a ``dots`` forward keeps more than ``full``
    and less than no remat."""
    cfg = get_config("smollm-360m").reduced(**KW)
    model = build_model(cfg, RunConfig(**RUN), device="cpu")
    model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    batch = _torch_batch(_batch(cfg))
    kept_ops = []
    policy = remat._dots

    def spy(ctx, op, *args, **kw):
        decision = policy(ctx, op, *args, **kw)
        if decision == remat.CheckpointPolicy.MUST_SAVE:
            kept_ops.append((op, ctx.op_output.numel()))
        return decision

    monkeypatch.setattr(remat, "_dots", spy)

    def kept(**run):
        model.run = dataclasses.replace(model.run, **run)
        del kept_ops[:]
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss_fn(batch)
        torch.autograd.grad(loss, list(model.parameters()))
        return len(sizes) + len(kept_ops), sum(sizes) + sum(
            n for _, n in kept_ops)

    none = kept(remat=False)
    full = kept(remat=True, remat_policy="full")
    dots = kept(remat=True, remat_policy="dots")
    assert kept_ops and {op for op, _ in kept_ops} <= set(remat.SAVED_BY_DOTS)
    # per layer: q, k, v, wo, gate, up, down
    assert len(kept_ops) == 7 * cfg.n_layers
    assert full[0] < dots[0] < none[0]
    assert full[1] < dots[1] < none[1]


# -- the dry run ------------------------------------------------------------------

def test_dry_run_temp_bytes_fall_with_remat():
    """qwen3-32b at 4 layers, a train cell of 4 x 512 on one device: the
    peak of live bytes of the step is lower with remat on."""
    cfg = get_config("qwen3-32b").reduced(n_layers=4)
    mesh = fake_mesh((1, 1), (0, 0))
    shape = ShapeSpec("t", 512, 4, "train")
    temps = {}
    for on in (False, True):
        rc = default_run_config(mesh, SHAPES["train_4k"], attn_impl="plain",
                                remat=on)
        with S.use_mesh(mesh):
            temps[on] = D._peak(D.prepare("qwen3-32b", shape, mesh, rc,
                                          cfg)[0])[0]
    assert 0 < temps[True] < temps[False]


_COLL = r"""
import json, threading
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
from repro_torch.configs import get_config
from repro_torch.launch.collectives import record_collectives
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig, build_model
mesh = S.make_mesh((1, 2), ("data", "model"), "cpu")
out = {}
for arch in ("qwen3-32b", "rwkv6-7b"):
    cfg = get_config(arch).reduced(n_layers=3)
    for remat in (False, True):
        run = RunConfig(attn_impl="plain", q_chunk=32, kv_chunk=32,
                        seq_chunk=16, remat=remat, data_axes=("data",))
        with S.use_mesh(mesh):
            model = build_model(cfg, run, device="meta")
        model.requires_grad_(True)
        toks = torch.zeros((2, 32), dtype=torch.int32, device="meta")
        with record_collectives() as recs:
            with S.use_mesh(mesh):
                loss = model.loss_fn({"tokens": toks, "labels": toks})
            params = list(model.parameters())
        # the backward on a thread of its own, as autograd runs a CUDA one
        t = threading.Thread(target=torch.autograd.grad, args=(loss, params))
        t.start()
        t.join()
        out[f"{arch}|{remat}"] = [r["kind"] for r in recs]
print(json.dumps(out))
"""


def test_recompute_runs_the_collectives_again_and_logs_them():
    """On a fake (1, 2) mesh, the loss in this thread inside the log and
    the gradients on a thread of its own: with remat on the log holds, once
    more a layer, the forward's collectives that the recompute runs (it
    enters the forward's mesh and log). The recompute stops at the last
    value the backward needs: DecoderLM's ``wo`` all-reduce, not the
    MLP's, whose sum ends the layer and is kept by nothing in it; RWKV6's
    four (the group norm's and ``c_r``'s all-gathers, ``w_o``'s and
    ``c_v``'s all-reduces), whose channel-mix product keeps both its
    factors."""
    run = subprocess.run([sys.executable, "-c", _COLL],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    layers = 3
    for arch, per_layer in (("qwen3-32b", {"all-reduce": 1}),
                            ("rwkv6-7b", {"all-reduce": 2, "all-gather": 2})):
        off, on = got[f"{arch}|False"], got[f"{arch}|True"]
        extra = {k: on.count(k) - off.count(k) for k in set(on) | set(off)}
        assert {k: n for k, n in extra.items() if n} == {
            k: n * layers for k, n in per_layer.items()}, (arch, off, on)
