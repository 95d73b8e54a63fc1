"""The port's planning half of ``launch/``: the dry run on meta tensors
(``launch/dryrun.py``), its collective log (``launch/collectives.py``, the
counterpart of ``hlo_parse.py``) and the roofline on the H100's peaks
(``launch/roofline.py``), against the JAX package's arithmetic where it is
kept and against hand counts where the port counts for itself.

A fake default process group is process-wide, so every test that needs
one runs its work in a subprocess (the dry run's CLI, or a snippet).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as JR  # noqa: E402
from repro_torch.configs import (SHAPES, all_arch_names,  # noqa: E402
                                 applicable_shapes, get_config)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch.collectives import summarize  # noqa: E402
from repro_torch.launch.steps import default_run_config  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402

from torch_port_util import SRC, fake_mesh  # noqa: E402

CELLS = [(a, s) for a in all_arch_names()
         for s in applicable_shapes(get_config(a))]


def _run(code, timeout=600):
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# -- roofline: the reference's arithmetic, the card's constants ----------------

def test_every_applicable_cell_is_counted():
    """32 (arch x shape) cells: every arch's three shapes, long_500k for
    the two sub-quadratic ones."""
    assert len(CELLS) == 32


@pytest.mark.parametrize("n_devices", [256, 512])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape, n_devices):
    assert R.model_flops_per_device(arch, shape, n_devices) == \
        JR.model_flops_per_device(arch, shape, n_devices)


def test_collective_bytes_on_wire_equal_the_reference():
    rng = np.random.default_rng(5)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    for _ in range(50):
        summary = {k: {"bytes": float(rng.integers(0, 1 << 40)),
                       "count": int(rng.integers(1, 99)),
                       "group": [None, 1, 2, 16, 256][rng.integers(0, 5)]}
                   for k in kinds if rng.random() < 0.7}
        assert R.collective_bytes_on_wire(summary) == \
            JR.collective_bytes_on_wire(summary)


def test_roofline_terms_on_the_cards_constants():
    """The terms of one record: FLOPs at the dtype's peak, bytes at HBM3's
    rate, a collective over 16 ranks (two nodes) at 50 GB/s and one over 8
    (one node) at NVLink's 450 GB/s; ``fits`` against 80 GB."""
    rec = {"arch": "qwen3-32b", "shape": "decode_32k", "status": "ok",
           "n_devices": 256, "dtype": "bfloat16",
           "cost": {"flops": 989e12, "bytes_accessed": 3.35e12,
                    "collectives": {
                        "all-gather": {"bytes": 16e9, "count": 1,
                                       "group": 16},
                        "all-reduce": {"bytes": 8e9, "count": 1,
                                       "group": 8}}},
           "memory": {"argument_bytes": 70e9, "output_bytes": 1e9,
                      "temp_bytes": 20e9, "alias_bytes": 1e9}}
    row = R.analyze_cell(rec)
    assert row.compute_s == pytest.approx(1.0)
    assert row.memory_s == pytest.approx(1.0)
    assert row.collective_s == pytest.approx(15e9 / 50e9 + 14e9 / 450e9)
    assert not row.fits and row.hbm_gib == pytest.approx(90e9 / 2**30)
    assert R.peak_flops("float32") == 67e12 and R.peak_flops("tf32") == 495e12


# -- the probe solver and the counts -------------------------------------------

FAMILIES = [("qwen3-32b", dict(n_layers=4)), ("arctic-480b", dict(n_layers=4)),
            ("rwkv6-7b", dict(n_layers=4)),
            ("zamba2-2.7b", dict(n_layers=8)),   # four blocks of attn_every 2
            ("whisper-small", dict(n_layers=4))]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch,kw", FAMILIES)
def test_probes_extrapolate_to_the_full_depth_trace(arch, kw, shape):
    """The affine solver over the probes gives exactly the FLOPs of a
    full-depth trace, one reduced config of each family (whisper with 3
    encoder layers beside its 4 decoder layers)."""
    import dataclasses
    cfg = get_config(arch).reduced(**kw)
    if cfg.enc_dec is not None:
        cfg = dataclasses.replace(cfg, enc_dec=dataclasses.replace(
            cfg.enc_dec, n_encoder_layers=3))
    mesh = fake_mesh((1, 1), (0, 0))
    rc = D.probe_run_config(mesh, SHAPES[shape])
    variants, solve = D._probe_variants(cfg)
    with S.use_mesh(mesh):
        probes = {t: D.counted(D.prepare(arch, shape, mesh, rc, c)[0])
                  for t, c in variants}
        full = D.counted(D.prepare(arch, shape, mesh, rc, cfg)[0])
    assert solve({t: c["flops"] for t, c in probes.items()}) == full["flops"]
    assert full["flops"] > 0


def test_dense_decode_flops_equal_a_hand_count():
    """qwen3-32b reduced, one device, decode_32k: every product of the
    step, counted by hand (K1's plain form scores the whole cache)."""
    cfg = get_config("qwen3-32b").reduced(n_layers=3)
    mesh = fake_mesh((1, 1), (0, 0))
    rc = default_run_config(mesh, SHAPES["decode_32k"], attn_impl="plain")
    with S.use_mesh(mesh):
        got = D.counted(D.prepare("qwen3-32b", "decode_32k", mesh, rc,
                                    cfg)[0])["flops"]
    sp = SHAPES["decode_32k"]
    b, smax = sp.global_batch, sp.seq_len
    d, hd, f, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * b * d * hq * hd            # wq
             + 2 * 2 * b * d * hkv * hd     # wk, wv
             + 2 * b * hq * hd * d          # wo
             + 2 * 2 * b * hq * smax * hd   # q.k over the cache, p.v
             + 3 * 2 * b * d * f)           # w_gate, w_up, w_down
    assert got == cfg.n_layers * layer + 2 * b * d * v


def test_traffic_counts_operands_and_results():
    """Views and allocations count 0; a product its operands and result;
    the peak follows live storages."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    with D.Traffic() as t:
        v = a.view(32, 64)              # a view: no bytes
        c = a @ b                       # 8 KiB + 2 KiB read, 4 KiB written
        e = torch.empty(1 << 20, device="meta")
        del e
    assert t.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert t.peak == 4 * ((1 << 20) + 64 * 16) and t.live == 4 * 64 * 16
    assert v.shape == (32, 64) and c.shape == (64, 16)


# -- the collective log on a fake (2, 4) group ------------------------------------

_COLL = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import sharding as S
mesh = S.make_mesh((2, 4), ("data", "model"), "cpu")
out = {}
for arch, n in (("qwen3-32b", 3), ("rwkv6-7b", 3), ("zamba2-2.7b", 6)):
    cfg = get_config(arch).reduced(n_layers=n)
    for shape in ("prefill_32k", "decode_32k"):
        rc = D.probe_run_config(mesh, SHAPES[shape])
        with S.use_mesh(mesh):
            c = D.counted(D.prepare(arch, shape, mesh, rc, cfg)[0])
        out[f"{arch}|{shape}"] = c["collectives"]
# a backward on a thread of its own (autograd's CUDA device thread) notes
# into the log its forward ran under
import threading, torch
from repro_torch.launch.collectives import record_collectives
x = torch.empty(4, 8, device="meta", requires_grad=True)
with record_collectives() as recs:
    y = S.copy_to(x, "model", mesh).sum()
t = threading.Thread(target=y.backward)
t.start()
t.join()
out["backward_thread"] = [r["kind"] for r in recs]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_2x4():
    return json.loads(_run(_COLL).strip().splitlines()[-1])


def _counts(summary):
    return {k: v["count"] for k, v in summary.items()}



def test_qwen3_collectives_equal_the_code(fake_2x4):
    """DecoderLM on (2, 4), L = 3: per layer ``wo``'s and the MLP's
    ``psum`` (all-reduce), plus the embedding's; decode gathers each
    layer's K and V cache (the GSPMD baseline), and the logits are
    gathered once. Bytes: fp32 sums of (B/2, S, d), gathers of the whole
    cache and logits."""
    cfg = get_config("qwen3-32b").reduced(n_layers=3)
    n, d, v, hd = 3, cfg.d_model, cfg.vocab, cfg.resolved_head_dim
    pre, dec = fake_2x4["qwen3-32b|prefill_32k"], \
        fake_2x4["qwen3-32b|decode_32k"]
    assert _counts(pre) == {"all-reduce": 2 * n + 1, "all-gather": 1}
    assert _counts(dec) == {"all-reduce": 2 * n + 1, "all-gather": 2 * n + 1}
    bp, s = SHAPES["prefill_32k"].global_batch // 2, SHAPES["prefill_32k"].seq_len
    bd, smax = SHAPES["decode_32k"].global_batch // 2, SHAPES["decode_32k"].seq_len
    assert pre["all-reduce"]["bytes"] == (2 * n + 1) * bp * s * d * 4
    assert pre["all-gather"]["bytes"] == bp * s * v * 4
    assert dec["all-reduce"]["bytes"] == (2 * n + 1) * bd * d * 4
    assert dec["all-gather"]["bytes"] == \
        2 * n * bd * smax * cfg.n_kv_heads * hd * 4 + bd * v * 4
    assert all(c["group"] == 4 for c in (*pre.values(), *dec.values()))


def test_rwkv6_and_zamba2_collectives_equal_the_code(fake_2x4):
    """RWKV6: 4 a layer + 2 (PERF.md writes "rwkv6 4L + 2"); Zamba2: 3 a
    mixer, 2 a shared block (+1 in decode: the new K/V heads gathered),
    + 2."""
    for shape in ("prefill_32k", "decode_32k"):
        assert sum(_counts(fake_2x4[f"rwkv6-7b|{shape}"]).values()) \
            == 4 * 3 + 2
        blocks = 3                               # 6 mixers, attn_every 2
        assert sum(_counts(fake_2x4[f"zamba2-2.7b|{shape}"]).values()) \
            == 3 * 6 + (2 + (shape == "decode_32k")) * blocks + 2


def test_a_backward_on_another_thread_is_logged(fake_2x4):
    """``copy_to``'s backward (an all-reduce) run on a thread of its own,
    as autograd runs a CUDA backward, lands in the log that was active
    when its forward ran."""
    assert fake_2x4["backward_thread"] == ["all-reduce"]


def test_summarize_is_the_references_collect():
    recs = [{"kind": "all-reduce", "bytes": 8, "group": 4},
            {"kind": "all-gather", "bytes": 32, "group": 4},
            {"kind": "all-reduce", "bytes": 4, "group": 2}]
    assert summarize(recs) == {
        "all-reduce": {"count": 2, "bytes": 12, "group": 2},
        "all-gather": {"count": 1, "bytes": 32, "group": 4}}


def test_no_log_records_nothing():
    """Outside ``record_collectives`` the log is off: a collective runs
    and nothing is kept."""
    from repro_torch.launch.collectives import record_collectives
    with record_collectives() as recs:
        pass
    assert recs == [] and S._LOG.get() is None


# -- the CLI on the production mesh -------------------------------------------------

def test_full_config_cell_through_the_cli(tmp_path):
    """qwen3-32b x decode_32k on (16, 16), 256 fake ranks, in a process of
    its own: status ok, the reference's record layout, and the collectives
    of 64 layers (2 a layer + 1 of each kind)."""
    out = tmp_path / "dr"
    _run(f"import sys; sys.argv = ['dryrun', '--arch', 'qwen3-32b', "
         f"'--shape', 'decode_32k', '--mesh', 'single', '--out', "
         f"{str(out)!r}]\nfrom repro_torch.launch import dryrun\n"
         "dryrun.main()")
    rec = json.loads((out / "qwen3-32b_decode_32k_single.json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256
    assert {"flops", "bytes_accessed", "collectives", "method"} <= \
        set(rec["cost"])
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "alias_bytes", "method"} <= set(rec["memory"])
    assert _counts(rec["cost"]["collectives"]) == {"all-reduce": 129,
                                                   "all-gather": 129}
    row = R.load_rows(str(out))[0]
    assert row.status == "ok" and row.bottleneck == "collective"
