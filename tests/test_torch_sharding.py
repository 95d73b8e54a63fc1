"""The port's sharding layer (``models/sharding.py``, ``launch/mesh.py``)
against the reference's: every family's partition-spec trees, spec
filtering, shards and collectives on a gloo group of four CPU processes,
and K1's log-sum-exp output (what the sequence-sharded decode merges
with) against ``jax.nn.logsumexp`` of the reference's masked scores."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES, all_arch_names  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.models.sharding import P  # noqa: E402
from torch_port_util import port_sharding_job, spawn_gloo  # noqa: E402


def _flat(tree, prefix=""):
    """The reference's nested spec tree keyed by ``state_dict`` names, each
    spec as a tuple."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", all_arch_names())
def test_spec_trees_equal_the_reference(name, fsdp):
    """``param_pspecs`` (keyed as ``state_dict``), ``input_pspecs`` and
    ``cache_pspecs`` of every family, on every config's reduced form, for
    each shape kind at batch 1 and 4."""
    mj = jbuild(jget(name).reduced(), JRun(fsdp_experts=fsdp))
    mt = build_model(get_config(name).reduced(), RunConfig(fsdp_experts=fsdp),
                     device="meta")
    assert _flat(mj.param_pspecs()) == mt.param_pspecs()
    assert set(mt.param_pspecs()) == set(mt.state_dict())
    for shape in SHAPES.values():
        for b in (1, 4):
            s = dataclasses.replace(shape, global_batch=b)
            assert _flat(mj.input_pspecs(s)) == mt.input_pspecs(s)
            assert _flat(mj.cache_pspecs(s)) == mt.cache_pspecs(s)


def test_partition_spec_twin_equals_the_reference_as_tuples():
    cases = [(None, "model"), (("pod", "data"), None), (), (["data"], None),
             (("data",), "model"), ([], None), (["pod", "data"],)]
    for entries in cases:
        assert P(*entries) == tuple(JP(*entries))
    assert isinstance(P(["a", "b"])[0], tuple)


def test_filter_spec_with_no_mesh_is_none():
    assert S.filter_spec(P("model", None)) is None      # no mesh -> no-op
    assert JS.filter_spec(JP("model", None)) is None
    assert S.mesh_axis_sizes() == {} and S.get_mesh() is None
    x = torch.zeros(2)
    assert S.constrain(x, P("data", None, None)) is x
    assert S.psum(x, "model") is x and S.all_gather(x, "data", 0) is x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    spawn_gloo(port_sharding_job, 4, tmp, str(tmp / "out"))
    out = []
    for r in range(4):
        with open(tmp / f"out.{r}.json") as fh:
            out.append(json.load(fh))
    return out


def test_filter_spec_on_a_mesh_matches_the_reference(ranks):
    """Axes the mesh lacks are dropped, as the reference drops them under
    a mesh of the same axis names (one real device here)."""
    for key, names in (("2x2", ("data", "model")),
                       ("2x1x2", ("pod", "data", "model"))):
        mesh = JS.compat_make_mesh((1,) * len(names), names)
        with JS.use_mesh(mesh):
            want = [list(map(repr, (S.P(*JS.filter_spec(s)))))
                    for s in (JP(("pod", "data"), None, "model"),
                              JP("model", None), JP(None, ("data", "model")))]
        for r in ranks:
            assert r[key + ".filter"] == want
            assert list(r[key + ".sizes"]) == list(names)


def test_local_shards_and_gather_round_trip(ranks):
    """A rank's slice of a (4, 6, 8) tensor under each spec, by the rank's
    coordinate; the gather gives the whole back on every rank."""
    full = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    for key, names in (("2x2", ("data", "model")),
                       ("2x1x2", ("pod", "data", "model"))):
        sizes = dict(zip(names, (2, 2) if key == "2x2" else (2, 1, 2)))
        for r in ranks:
            c = r[key + ".coord"]

            def part(axes, n):
                live = [a for a in names if a in axes and sizes[a] > 1]
                k = math.prod(sizes[a] for a in live)
                i = 0
                for a in live:
                    i = i * sizes[a] + c[a]
                return slice(i * n // k, (i + 1) * n // k)

            for spec, idx in (
                    (P(("pod", "data"), None, "model"),
                     (part(("pod", "data"), 4), slice(None),
                      part(("model",), 8))),
                    (P(None, "model"), (slice(None), part(("model",), 6))),
                    (P(None, None, ("data", "model")),
                     (slice(None), slice(None), part(("data", "model"), 8))),
                    (P(), ())):
                shape, total, back = r[f"{key}.{spec!r}"]
                assert shape == list(full[idx].shape)
                assert total == float(full[idx].sum()) and back


def test_collectives_over_one_axis_and_a_tuple_of_axes(ranks):
    for key in ("2x2", "2x1x2"):
        for rank, r in enumerate(ranks):
            c = r[key + ".coord"]
            model_peers = [q + 1 for q, o in enumerate(ranks)
                           if all(o[key + ".coord"][a] == c[a]
                                  for a in c if a != "model")]
            data_peers = [q + 1 for q, o in enumerate(ranks)
                          if o[key + ".coord"]["model"] == c["model"]]
            assert r[key + ".psum_model"] == [float(sum(model_peers))] * 3
            assert r[key + ".psum_all"] == [10.0] * 3     # 1+2+3+4, in bf16
            assert r[key + ".pmax_data"] == [float(max(data_peers))] * 3
            assert r[key + ".gather_model"] == [[float(q)] * 3
                                                for q in model_peers]
            assert r[key + ".constrain"] is True


def test_indivisible_dimension_raises_naming_the_leaf(ranks):
    """As ``jax.jit`` with such an ``in_shardings`` does (the reference
    raises ValueError there too; GSPMD pads only its own intermediates)."""
    for r in ranks:
        for key in ("2x2", "2x1x2"):
            msg = r[key + ".indivisible"]
            assert "w_odd" in msg and "not divisible by the 4 shards" in msg


def test_local_and_production_meshes(ranks):
    for r in ranks:
        assert r["local_mesh"] == [["data", "model"], [2, 2]]
        assert "(16, 16) needs 256 ranks; the world has 4" in r["refused"][0]
        assert "needs 3 ranks" in r["refused"][1]


# -- K1's log-sum-exp ----------------------------------------------------------

def _jax_lse(q, k, lens):
    """``jax.nn.logsumexp`` of the reference's scaled, length-masked scores
    (``decode_attention_jnp``'s, with -inf where it puts -1e30)."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(b, 1, hkv, hq // hkv, d)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k)) / math.sqrt(d)
    mask = jnp.arange(k.shape[1])[None, :] < jnp.asarray(lens)[:, None]
    s = jnp.where(mask[:, None, None, None, :], s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, hq)


@pytest.mark.parametrize("lens", [[0, 5, 16, 9], [3, 3, 3, 3], [0, 0, 1, 2]])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (14, 2)])
def test_decode_lse_matches_jax_logsumexp(lens, hq, hkv):
    rng = np.random.default_rng(hq * 7 + sum(lens))
    b, smax, d = 4, 16, 8
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lt = torch.tensor(lens)
    out, lse = decode_attention(tq, tk, tv, lt, return_lse=True)
    assert lse.shape == (b, hq) and lse.dtype == torch.float32
    want = _jax_lse(q, k, lens)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(lse.numpy()[live], want[live], atol=2e-5,
                               rtol=2e-5)
    # the default call is unchanged, and ops passes the flag through
    assert torch.equal(out, decode_attention(tq, tk, tv, lt))
    assert torch.equal(out, decode_attention_plain(tq, tk, tv, lt))
    o2, l2 = ops.decode_attention(tq, tk, tv, lt, impl="plain",
                                  return_lse=True)
    assert torch.equal(o2, out) and torch.equal(l2, lse)
