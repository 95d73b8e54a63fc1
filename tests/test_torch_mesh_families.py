"""RWKV6, Zamba2 and Whisper computing on a mesh, against the reference.

Built inside ``use_mesh``, each family holds its shards of
``param_pspecs()`` and runs the tensor-parallel arithmetic GSPMD derives
from them: K3's and K4's recurrences at the rank's heads, Zamba2's packed
``in_proj`` resharded across its head boundaries (the reduced config's 296
columns, 74 a rank), Whisper's heads split with its caches replicated.
Both sides get the same numpy weights (``mf_inputs``); the reference runs
on four fake CPU devices in a subprocess (``forward`` jitted with its
specs' shardings, then decode steps through its own
``launch.steps.build_step``), the port on a gloo group of four CPU
processes through ``repro_torch.launch.steps.build_step``. Tolerances:
2e-4 for logits (tests/test_models_smoke.py's model bound), ×5 for the
recurrent families (tests/test_kernels.py's recurrence factor).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_arch_names, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from torch_port_util import (MF_DECODE, MF_DECODE_LEGS,  # noqa: E402
                             MF_STEPS, fake_mesh, finish, mf_inputs,
                             port_mesh_families_job, spawn_gloo,
                             start_jax_mesh)

TOL = {"rwkv6-7b": 1e-3, "zamba2-2.7b": 1e-3, "whisper-small": 2e-4}
LEGS = [(n, b) for n in MF_DECODE for _, b in MF_DECODE_LEGS[n]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_families")
    inputs = str(tmp / "inputs.npz")
    mf_inputs(inputs)
    jax_proc = start_jax_mesh("jax_mesh_families_main", 4, inputs,
                              str(tmp / "jax.npz"))
    try:
        spawn_gloo(port_mesh_families_job, 4, tmp, inputs,
                   str(tmp / "port"))
    finally:
        out = finish(jax_proc)
    assert "jax mesh families ok" in out
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"port.{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("name", MF_DECODE)
def test_forward_on_the_mesh_matches_jax(runs, name):
    """Every rank's logits (gathered over the vocabulary where the head
    is split) and ``build_step``'s prefill (the last position's)."""
    ref, port = runs
    tol = TOL[name]
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{name}|fwd"],
                                   ref[f"{name}|fwd"], atol=tol, rtol=tol)
        np.testing.assert_allclose(port[r][f"{name}|last"],
                                   ref[f"{name}|fwd"][:, -1], atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("name,b", LEGS, ids=[f"{n}-b{b}" for n, b in LEGS])
def test_decode_on_the_mesh_matches_jax(runs, name, b):
    """``build_step``'s decode for MF_STEPS steps from an empty cache
    (Whisper's cross cache filled by ``prefill_cross``)."""
    ref, port = runs
    tol = TOL[name]
    for r in range(4):
        for t in range(MF_STEPS):
            np.testing.assert_allclose(port[r][f"{name}|b{b}|dec{t}"],
                                       ref[f"{name}|b{b}|dec{t}"],
                                       atol=tol, rtol=tol,
                                       err_msg=f"rank {r} step {t}")


@pytest.mark.parametrize("name", MF_DECODE)
def test_bf16_on_the_mesh_rounds_as_one_device(runs, name):
    """In bf16 a row-parallel product's partials are summed in fp32 and
    rounded once (``sharding.psum_matmul``), as one device rounds the whole
    product: the port's mesh and one device agree within the bf16 kernel
    bound (tests/test_kernels.py's 2e-2)."""
    _, port = runs
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{name}|bf16|mesh"],
                                   port[r][f"{name}|bf16|one"], atol=2e-2,
                                   rtol=2e-2)


def _heads(a, r, n=4):
    """Rank ``r``'s part of dim 3 (heads) of a (L, B, S, H, D) array."""
    h = a.shape[3] // n
    return a[:, :, :, r * h:(r + 1) * h]


@pytest.mark.parametrize("b", [2, 1])
def test_zamba2_cache_layouts(runs, b):
    """Batch 2: the KV cache is replicated over the model axis (every rank
    holds all heads, the reference's ``P(None, dax, None, None, None)``);
    batch 1: each rank holds its heads (``long_500k``'s layout). The ssd
    state holds the rank's SSD heads, the conv state its conv channels."""
    ref, port = runs
    pre = f"zamba2-2.7b|b{b}|cache|"
    for r in range(4):
        for kv in "kv":
            want = ref[pre + kv] if b > 1 else _heads(ref[pre + kv], r)
            np.testing.assert_allclose(port[r][pre + kv], want, atol=1e-3,
                                       rtol=1e-3)
        h = ref[pre + "ssd"].shape[3] // 4
        np.testing.assert_allclose(port[r][pre + "ssd"],
                                   ref[pre + "ssd"][:, :, :, r * h:(r + 1) * h],
                                   atol=1e-3, rtol=1e-3)
        c = ref[pre + "conv"].shape[-1] // 4
        np.testing.assert_allclose(port[r][pre + "conv"],
                                   ref[pre + "conv"][..., r * c:(r + 1) * c],
                                   atol=1e-3, rtol=1e-3)


def test_whisper_caches_stay_replicated(runs):
    """The self and cross caches hold every head on every rank (the new
    heads gathered before each write and at ``prefill_cross``)."""
    ref, port = runs
    pre = f"whisper-small|b2|cache|"
    for r in range(4):
        for k in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(port[r][pre + k], ref[pre + k],
                                       atol=2e-4, rtol=2e-4, err_msg=k)


def test_rwkv_state_holds_the_rank_heads(runs):
    ref, port = runs
    pre = "rwkv6-7b|b2|cache|"
    h = ref[pre + "wkv"].shape[2] // 4
    for r in range(4):
        np.testing.assert_allclose(port[r][pre + "wkv"],
                                   ref[pre + "wkv"][:, :, r * h:(r + 1) * h],
                                   atol=1e-3, rtol=1e-3)
        for k in ("shift_att", "shift_ffn"):
            np.testing.assert_allclose(port[r][pre + k], ref[pre + k],
                                       atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", all_arch_names())
def test_every_family_takes_its_shards(name):
    """Built inside ``use_mesh`` (1, 4), every parameter of every family
    has its ``local_shape``: no family ignores the mesh and allocates (or
    computes) the whole model."""
    cfg = get_config(name).reduced()
    mesh = fake_mesh((1, 4), (0, 3))
    with S.use_mesh(mesh):
        m = build_model(cfg, RunConfig(), device="meta")
    specs, full = m.param_pspecs(), m.param_shapes()
    shapes = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert set(shapes) == set(full)
    for k, shape in shapes.items():
        assert shape == S.local_shape(full[k][0], specs[k], mesh, k), k
    assert any(shape != tuple(full[k][0]) for k, shape in shapes.items())


@pytest.mark.parametrize("name", all_arch_names())
def test_cache_shapes_are_the_global_cache(name):
    """``cache_shapes`` (the global layout ``build_step``'s example cache
    takes) is the cache with no mesh, and ``init_cache`` on (1, 4) holds
    its ``local_shape`` of it by ``cache_pspecs``."""
    cfg = get_config(name).reduced()
    shape = ShapeSpec("d", 16, 2, "decode")
    full = build_model(cfg, RunConfig(), device="meta").cache_shapes(shape)
    one = build_model(cfg, RunConfig(), device="meta").init_cache(shape)
    assert {k: (tuple(t.shape), t.dtype) for k, t in one.items()} == \
        {k: (tuple(d), dt) for k, (d, dt) in full.items()}
    mesh = fake_mesh((1, 4), (0, 3))
    with S.use_mesh(mesh):
        m = build_model(cfg, RunConfig(), device="meta")
    specs = m.cache_pspecs(shape)
    for k, t in m.init_cache(shape).items():
        assert tuple(t.shape) == S.local_shape(full[k][0], specs[k], mesh, k)


def test_zamba2_batch_one_on_data_ranks_names_a13d():
    """A batch of 1 with data ranks above one takes the reference's
    sequence-parallel KV cache (ROADMAP A13d, done): its sequence split over
    the data axis and its KV heads over the model axis, the SSD and conv
    states replicated over the data axis. With a model axis of one rank the
    layout is refused: its cache could not be told from a batch split one
    row a rank."""
    cfg = get_config("zamba2-2.7b").reduced()
    with S.use_mesh(fake_mesh((2, 2), (1, 0))):
        m = build_model(cfg, RunConfig(data_axes=("data",)), device="meta")
    one = m.init_cache(ShapeSpec("long", 8, 1, "decode"))
    assert one["k"].shape == (1, 1, 4, cfg.n_kv_heads // 2,
                              cfg.resolved_head_dim)
    assert one["ssd"].shape[2] == 1
    assert one["ssd"].shape[3] == m.n_ssm_heads // 2
    assert m.init_cache(ShapeSpec("d", 8, 2, "decode"))["k"].shape[1] == 1
    with S.use_mesh(fake_mesh((2, 1), (1, 0))):
        dp = build_model(cfg, RunConfig(data_axes=("data",)), device="meta")
    with pytest.raises(ValueError, match="model axis of more than one"):
        dp.init_cache(ShapeSpec("long", 8, 1, "decode"))
