"""The mesh layouts the production mesh needs: padded heads and
vocabularies, the KV-head-sharded cache, Zamba2's batch-1 cache on data
ranks, against the reference on the same fake-device meshes.

* smollm cut to 3 query heads on 1 KV head and a vocabulary of 250: on
  (1, 4) each rank holds one head (the last a zero head) and 63 vocabulary
  rows (the last rank's two last zero rows); on (2, 2) two heads a rank.
  The reference keeps a leaf the mesh does not divide replicated (the
  vocabulary of 250 on 4) and lets GSPMD pad what it partitions;
* qwen3 cut to 16 KV heads: ``wk``/``wv`` and the cache split by heads;
* Zamba2 with a batch of 1 on (2, 2): its KV cache's sequence over the data
  axis (4 positions a rank, crossed at step 4) and its heads over the
  model axis, through both packages' ``build_step``.

The port runs on a gloo group of four CPU processes, the reference on four
fake CPU devices in a subprocess, the one-device port on rank 0.
Tolerances: the reference's, 2e-4 for logits (tests/test_models_smoke.py),
x5 for Zamba2's recurrence (tests/test_kernels.py), greedy tokens equal;
training as tests/test_torch_mesh_train.py (losses rtol 1e-5, parameters
atol 1e-4 / rtol 1e-3).
"""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import sharding as S  # noqa: E402
from torch_port_util import (PAD_MESHES, PAD_STEPS,  # noqa: E402
                             PAD_TRAIN_STEPS, ZB1_STEPS, finish, pad_cfg,
                             pad_inputs, pad_tree, port_mesh_pad_job,
                             spawn_gloo, start_jax_mesh)

LM_TOL = 2e-4
ZB1_TOL = 1e-3
TAGS = [f"{a}x{b}" for a, b in PAD_MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_pad")
    inputs = str(tmp / "inputs.npz")
    pad_inputs(inputs)
    jax_proc = start_jax_mesh("jax_mesh_pad_main", 4, inputs,
                              str(tmp / "jax.npz"))
    try:
        spawn_gloo(port_mesh_pad_job, 4, tmp, inputs, str(tmp / "port"),
                   str(tmp / "ckpt"))
    finally:
        out = finish(jax_proc)
    assert "jax mesh pad ok" in out
    return (tmp, inputs, dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"port.{r}.npz")) for r in range(4)])


def _rows(a, mshape, rank):
    """The batch rows rank ``rank`` holds on ``mshape`` (split over data)."""
    n_data = mshape[0]
    i = rank // mshape[1]
    b = a.shape[0] // n_data
    return a[i * b:(i + 1) * b]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("key", ["pad", "kvs"])
def test_forward_matches_jax_and_one_device(runs, key, tag):
    _, _, ref, port = runs
    mshape = tuple(int(x) for x in tag.split("x"))
    for r in range(4):
        got = port[r][f"{key}|{tag}|fwd"]
        assert got.shape[-1] == pad_cfg(key)[1].vocab
        _close(got, _rows(ref[f"{key}|{tag}|fwd"], mshape, r), LM_TOL)
        _close(got, _rows(port[0][f"{key}|one|fwd"], mshape, r), LM_TOL)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("key", ["pad", "kvs"])
def test_decode_matches_jax_and_one_device(runs, key, tag):
    """Decode steps from a seeded cache (the padded case on the
    sequence-sharded flash-decode, its owner moving across ranks; the
    KV-head-sharded case writing its own heads), then one step of per-slot
    lengths."""
    _, _, ref, port = runs
    mshape = tuple(int(x) for x in tag.split("x"))
    for r in range(4):
        for name in [f"dec{t}" for t in range(PAD_STEPS)] + ["slot"]:
            got = port[r][f"{key}|{tag}|{name}"]
            _close(got, _rows(ref[f"{key}|{tag}|{name}"], mshape, r), LM_TOL)
            _close(got, _rows(port[0][f"{key}|one|{name}"], mshape, r),
                   LM_TOL)


def test_zamba2_batch_one_on_data_ranks_matches_jax(runs):
    """The sequence-parallel cache: 4 positions a data rank, heads over the
    model axis; steps 0-5 write across the data ranks' boundary."""
    _, _, ref, port = runs
    _, cfg = pad_cfg("zb1")
    for r in range(4):
        assert list(port[r]["zb1|k_local"]) == [
            cfg.n_layers // cfg.ssm.attn_every, 1, 4, cfg.n_kv_heads // 2,
            cfg.resolved_head_dim]
        for t in range(ZB1_STEPS):
            got = port[r][f"zb1|2x2|dec{t}"]
            _close(got, ref[f"zb1|dec{t}"], ZB1_TOL)
            _close(got, port[0][f"zb1|one|dec{t}"], ZB1_TOL)


@pytest.mark.parametrize("tag", TAGS)
def test_padding_stays_zero_through_adamw(runs, tag):
    """3 AdamW steps (ZeRO-1 on (2, 2)): the padding is 0 after loading and
    after every step (an update leaves a zero entry zero only if its
    moments are), and the parameters and losses match one device."""
    _, _, _, port = runs
    for r in range(4):
        rec = port[r]
        assert rec[f"train|{tag}|zero_at_load"] == 1.0
        assert rec[f"train|{tag}|zero_after"] == 1.0
        for s in range(PAD_TRAIN_STEPS):
            np.testing.assert_allclose(rec[f"train|{tag}|loss{s}"],
                                       port[0][f"train|one|loss{s}"],
                                       rtol=1e-5)
        for k in [k for k in rec if k.startswith(f"train|{tag}|p|")]:
            np.testing.assert_allclose(
                rec[k], port[0][k.replace(tag, "one")], atol=1e-4,
                rtol=1e-3, err_msg=k)
    # (1, 4): the last rank holds a zero head and two zero vocabulary rows
    if tag == "1x4":
        assert port[3][f"train|{tag}|padded"] > 0
        assert port[0][f"train|{tag}|padded"] == 0


def test_checkpoint_from_a_padded_mesh_is_the_one_device_bytes(runs,
                                                               tmp_path):
    """The (1, 4) save holds no padding: every file equals the one-device
    save of the same weights, byte for byte; it restores onto (2, 2) (the
    ranks' padded shards, checked there) and onto one device."""
    from repro_torch import convert
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    tmp, inputs, _, port = runs
    z = np.load(inputs)
    _, cfg = pad_cfg("pad")
    m = build_model(cfg, RunConfig(), device="cpu")
    convert.load_params(m, pad_tree(z, "pad"))
    one = str(tmp_path / "one")
    save_checkpoint(one, 0, dict(m.named_parameters()))
    a, b = os.path.join(str(tmp / "ckpt"), "step_00000000"), \
        os.path.join(one, "step_00000000")
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and len(names) > 2
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
    got, _ = restore_checkpoint(str(tmp / "ckpt"), 0, dict(m.state_dict()))
    assert all(torch.equal(got[k], v) for k, v in m.state_dict().items())
    assert all(p["restore_2x2_equal"] == 1.0 for p in port)


def test_padded_entry_is_the_axis_to_the_reference():
    """A padded spec entry equals the plain axis (so the specs equal the
    reference's); its shards are whole blocks, zero-padded at the end, and
    ``gather`` drops the padding."""
    from torch_port_util import fake_mesh
    entry = S.Padded("model", 15 * 4, 4)
    assert S.P(None, entry) == S.P(None, "model")
    full = torch.arange(2 * 60, dtype=torch.float32).reshape(2, 60) + 1
    spec = S.P(None, entry)
    shards = [S.local_shard(full, spec, fake_mesh((1, 4), (0, r)))
              for r in range(4)]
    assert all(t.shape == (2, 16) for t in shards)
    assert torch.equal(torch.cat(shards, 1)[:, :60], full)
    assert not shards[3][:, 12:].any() and shards[3][:, :12].all()
    with pytest.raises(ValueError, match="not divisible"):
        S.local_shard(full, S.P(None, "model"), fake_mesh((1, 8), (0, 0)))
