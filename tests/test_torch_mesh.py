"""The port on a mesh against the reference on one: tensor-parallel
``DecoderLM``, the sequence-sharded flash-decode, expert-parallel and FSDP
MoE.

Both sides get the same numpy weights and inputs (``mesh_inputs``). The
reference runs on four fake CPU devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_moe.py's mesh tests do), jitted with the shardings of its own
``param_pspecs`` / ``input_pspecs`` / ``cache_pspecs``; the port runs on a
gloo group of four CPU processes (``launch.mesh.run_ranks``), every rank
holding its shards, and each rank's output is held against its rows of the
reference's. The two sides run at the same time, once for the module.
Tolerances: 2e-4 for logits and the MoE (tests/test_models_smoke.py's
model bound), 1e-4 for the sequence-sharded decode (tests/test_moe.py's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from torch_port_util import (MESH_SMAX, MESH_START,  # noqa: E402
                             MESH_STEPS, MESH_T, fake_mesh, finish,
                             mesh_inputs, port_mesh_job, spawn_gloo,
                             start_jax_mesh)

# rank -> (data, model) coordinate on each mesh the cases use
ON_2x2 = {r: (r // 2, r % 2) for r in range(4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = str(tmp / "inputs.npz")
    mesh_inputs(inputs)
    jax_proc = start_jax_mesh("jax_mesh_main", 4, inputs,
                              str(tmp / "jax.npz"))
    try:
        spawn_gloo(port_mesh_job, 4, tmp, inputs, str(tmp / "port"))
    finally:
        out = finish(jax_proc)
    assert "jax mesh ok" in out
    return (np.load(inputs), dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"port.{r}.npz")) for r in range(4)])


def _rows(a, data_index, n_data=2):
    b = a.shape[0] // n_data
    return a[data_index * b:(data_index + 1) * b]


def test_tensor_parallel_forward_matches_jax(runs):
    _, ref, port = runs
    for r in range(4):
        got = port[r]["tp_logits"]
        assert got.shape == ref["tp_logits"].shape     # (B_local=B, S, V)
        np.testing.assert_allclose(got, ref["tp_logits"], atol=2e-4,
                                   rtol=2e-4)


def test_mesh_init_keeps_the_single_device_slices(runs):
    assert all(float(p["init_equal"]) == 1.0 for p in runs[2])


def test_sequence_sharded_decode_matches_jax_across_a_shard_boundary(runs):
    """(2, 2): batch over data, the cache's 16 positions over model (8 a
    rank); the steps write positions 6..9, so the owner moves from model
    rank 0 to 1 on the third step."""
    _, ref, port = runs
    assert MESH_START < MESH_SMAX // 2 < MESH_START + MESH_STEPS
    for r, (di, mi) in ON_2x2.items():
        for t in range(MESH_STEPS):
            np.testing.assert_allclose(
                port[r][f"dec_logits_{t}"],
                _rows(ref[f"dec_logits_{t}"], di), atol=1e-4, rtol=1e-4)
        for kv in "kv":     # (L, B, Smax, Hkv, D): rows by data, positions
            want = ref[f"dec_{kv}"][:, di * 2:(di + 1) * 2,   # by model
                                    mi * 8:(mi + 1) * 8]
            np.testing.assert_allclose(port[r][f"dec_{kv}"], want,
                                       atol=1e-5, rtol=1e-5)


def test_gathered_cache_decode_and_per_slot_lengths(runs):
    """The other two branches of the decode: a scalar length without
    ``sharded_decode`` (the owner writes, the slices are gathered) against
    the reference's sharded decode, and then per-slot lengths (each row
    scattered into the rank that owns its position) against the
    reference's per-slot step on the same mesh."""
    _, ref, port = runs
    for r, (di, mi) in ON_2x2.items():
        for t in range(MESH_STEPS):
            np.testing.assert_allclose(
                port[r][f"gath_logits_{t}"],
                _rows(ref[f"dec_logits_{t}"], di), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(port[r]["slot_logits"],
                                   _rows(ref["slot_logits"], di), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(
            port[r]["slot_k"],
            ref["slot_k"][:, di * 2:(di + 1) * 2, mi * 8:(mi + 1) * 8],
            atol=1e-5, rtol=1e-5)


def test_query_heads_that_split_a_group_read_their_kv_heads(runs):
    """12 query heads on 3 KV heads over 2 model ranks: a rank's 6 heads
    span two groups unevenly, so it reads one KV head per query head;
    forward and sharded decode against the reference on the same mesh."""
    _, ref, port = runs
    for r, (di, _) in ON_2x2.items():
        np.testing.assert_allclose(port[r]["uneven_logits"],
                                   _rows(ref["uneven_logits"], di),
                                   atol=2e-4, rtol=2e-4)
        for t in range(MESH_STEPS):
            np.testing.assert_allclose(port[r][f"uneven_dec_{t}"],
                                       _rows(ref[f"uneven_dec_{t}"], di),
                                       atol=1e-4, rtol=1e-4)


def _kept_by_jax_shard(monkeypatch, cfg, w, x, n_shards, shard):
    """(token, local expert) of the rows the reference's ``_local_moe``
    keeps on one shard of ``n_shards``, read by spying on its first
    ``ragged_dot``."""
    seen = {}
    ragged_dot = jax.lax.ragged_dot

    def spy(lhs, rhs, group_sizes, *a, **kw):
        seen.setdefault("xin", np.asarray(lhs))
        seen.setdefault("sizes", np.asarray(group_sizes))
        return ragged_dot(lhs, rhs, group_sizes, *a, **kw)

    monkeypatch.setattr(jax.lax, "ragged_dot", spy)
    e = cfg.moe.n_experts // n_shards
    wj = {k: jnp.asarray(w[k]) if k == "router" else
          jnp.asarray(w[k][shard * e:(shard + 1) * e])
          for k in ("router", "e_gate", "e_up", "e_down")}
    JM._local_moe(cfg, JRun(moe_capacity_factor=1.25), wj, jnp.asarray(x),
                  n_shards=n_shards, shard_id=shard)
    n = int(seen["sizes"].sum())
    tok = ((seen["xin"][:n, None] - x[None]) ** 2).sum(-1).argmin(1)
    return list(zip(tok.tolist(),
                    np.repeat(np.arange(e), seen["sizes"]).tolist()))


def test_expert_parallel_moe_keeps_jax_assignments_and_matches(runs,
                                                               monkeypatch):
    """(1, 4) at capacity factor 1.25: each shard packs its own
    assignments up to T·k/4·1.25 rows, and some shard drops."""
    z, ref, port = runs
    cj = jget("arctic-480b").reduced()
    ct = get_config("arctic-480b").reduced()
    w = {k[4:]: z[k] for k in z.files if k.startswith("moe.")}
    x = z["moe_x"].reshape(-1, ct.d_model)
    e = ct.moe.n_experts // 4
    dropped = 0
    for shard in range(4):
        r = TM.route(ct, RunConfig(moe_capacity_factor=1.25),
                     torch.from_numpy(w["router"]), torch.from_numpy(x),
                     n_local=e, n_shards=4, shard_id=shard)
        kept = r.sel_e < e
        got = list(zip(r.sel_tok[kept].tolist(), r.sel_e[kept].tolist()))
        assert got == _kept_by_jax_shard(monkeypatch, cj, w, x, 4, shard)
        mine = int(((r.top_e >= shard * e) & (r.top_e < (shard + 1) * e))
                   .sum())
        dropped += mine - len(got)
    assert x.shape[0] == MESH_T and dropped > 0
    for r in range(4):
        np.testing.assert_allclose(port[r]["moe_ep"], ref["moe_ep"],
                                   atol=2e-4, rtol=2e-4)


def test_fsdp_experts_match_jax(runs):
    """(2, 2): experts over model, their FF dimension over data, gathered
    just in time; the batch's two rows one per data rank."""
    _, ref, port = runs
    for r, (di, _) in ON_2x2.items():
        np.testing.assert_allclose(port[r]["moe_fsdp"],
                                   _rows(ref["moe_fsdp"], di), atol=2e-4,
                                   rtol=2e-4)


def test_mesh_model_refuses_what_is_not_ported():
    """smollm's 15 heads on 4 ranks are padded to 16, as GSPMD pads them
    (4 a rank, the last rank's fourth a zero head); a KV-head split that
    the model axis does not divide is refused."""
    from repro_torch.models.sharding import use_mesh

    cfg = get_config("smollm-360m")
    with use_mesh(fake_mesh((1, 4), (0, 3))):
        m = build_model(cfg, RunConfig(), device="meta")
    assert m.layers["wq"].shape == (32, 960, 4 * 64)
    assert m._local_heads()[:3] == (12, 4, 3)
    wide = get_config("qwen3-32b").reduced(n_heads=36, n_kv_heads=18,
                                           d_model=72)
    with use_mesh(fake_mesh((1, 4), (0, 0))), pytest.raises(
            ValueError, match="18 KV heads do not split"):
        build_model(wide, RunConfig(), device="meta")
