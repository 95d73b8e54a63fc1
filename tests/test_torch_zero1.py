"""ZeRO-1, the data-parallel train step and elastic restore, against the
reference: the optimizer's partition specs (``zero1_pspec``,
``adamw_pspecs``), AdamW steps with moments sharded over the data axis on
a gloo group of four CPU processes against ``repro.train.optimizer.
adamw_update`` on one device (1e-5), the clip's global norm with
model-sharded leaves, a data-parallel ``Trainer`` with and without ZeRO-1,
and a checkpoint saved on (4, 1) restored bit for bit on (2, 1), on one
device and by the reference's ``restore_checkpoint``. Trainer
comparisons keep tests/test_train.py's tolerances (loss rtol 1e-5; params
atol 1e-4, rtol 1e-3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import all_arch_names  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import Trainer, run_config  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.models.sharding import P  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from torch_port_util import (ZERO1_CFG, ZERO1_SPECS, ZERO1_TREE,  # noqa: E402
                             port_zero1_job, spawn_gloo, zero1_tree)

TOL = dict(atol=1e-4, rtol=1e-3)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dax", [("pod", "data"), ("data",)])
@pytest.mark.parametrize("use_zero1", [True, False])
@pytest.mark.parametrize("name", all_arch_names())
def test_adamw_pspecs_equal_the_reference(name, use_zero1, dax):
    mj = jbuild(jget(name).reduced(), JRun())
    mt = build_model(get_config(name).reduced(), RunConfig(), device="meta")
    want = JO.adamw_pspecs(mj.param_pspecs(), mj.param_specs(),
                           use_zero1=use_zero1, dax=dax)
    got = O.adamw_pspecs(mt.param_pspecs(), mt.state_dict(),
                         use_zero1=use_zero1, dax=dax)
    assert got.step == tuple(want.step)
    for field in ("mu", "nu"):
        assert {k: tuple(v) for k, v in _flat(getattr(want, field)).items()
                } == getattr(got, field)


def test_zero1_pspec_cases_and_init_specs():
    cases = [(P(None, "model"), (128, 64)), (P("model", None), (4, 64)),
             (P(None, None), (3, 63)), (P(None, ("data",)), (128, 8)),
             (P(), (256,)), (P(None), (65,))]
    for spec, shape in cases:
        want = JO.zero1_pspec(JP(*spec), shape, ("pod", "data"))
        assert O.zero1_pspec(spec, shape, ("pod", "data")) == tuple(want)
    st = O.adamw_init_specs({"a": torch.empty(3, 4, dtype=torch.bfloat16)})
    assert st.mu["a"].is_meta and st.mu["a"].shape == (3, 4)
    assert st.mu["a"].dtype == torch.float32 and st.step.dtype == torch.int32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    out = str(tmp / "z")
    spawn_gloo(port_zero1_job, 4, tmp, out, "steps")
    spawn_gloo(port_zero1_job, 2, tmp, out, "resume")
    steps = [dict(np.load(f"{out}.steps.{r}.npz")) for r in range(4)]
    resume = [dict(np.load(f"{out}.resume.{r}.npz")) for r in range(2)]
    return out, steps, resume


def _jax_steps(p0, grads, clip):
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = JO.adamw_init(params)
    norms = []
    for g in grads:
        params, state, gnorm = JO.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, params,
            lr=1e-2, grad_clip=clip)
        norms.append(float(gnorm))
    return params, state, norms


def test_zero1_steps_match_adamw_update_with_the_global_norm(runs):
    """Two steps, the clip (5.0) active. ZeRO-1 shards the first free
    dimension of 64 or more: w's rows over data; e's free dimension (8) is
    too small, as are b and s. On (2, 2) w and e are model-sharded leaves
    too, so the norm needs their psum."""
    _, steps, _ = runs
    p0, grads = zero1_tree(1), [zero1_tree(2 + i) for i in range(2)]
    want, wstate, norms = _jax_steps(p0, grads, clip=5.0)
    assert norms[0] > 5.0                     # the clip acts
    for key, moments in (("4x1", {"w": 96 // 4 * 16, "e": 128 * 8,
                                  "b": 16, "s": 15}),
                         ("2x2", {"w": 96 // 2 * 16 // 2, "e": 128 // 2 * 8,
                                  "b": 16, "s": 15})):
        for r in steps:
            for i, n in enumerate(norms):
                np.testing.assert_allclose(r[f"{key}.gnorm{i}"], n,
                                           rtol=1e-6)
            for k in ZERO1_TREE:
                np.testing.assert_allclose(r[f"{key}.p.{k}"],
                                           np.asarray(want[k]), atol=1e-5,
                                           rtol=1e-5)
                np.testing.assert_allclose(r[f"{key}.mu.{k}"],
                                           np.asarray(wstate.mu[k]),
                                           atol=1e-5, rtol=1e-5)
                assert int(r[f"{key}.mu_local.{k}"]) == moments[k]


def test_zero1_equals_plain_data_parallel_and_one_device(runs):
    """ZeRO-1 changes where the moments live, not the arithmetic: its
    Trainer equals the data-parallel one without it bit for bit over four
    steps, holding a quarter of the moments. Against one device the
    gradients are averaged in another order; two steps stay within the
    reference's tolerances (AdamW's update at lr 3e-3 amplifies fp32
    reassociation where a gradient is near eps, so later steps drift)."""
    _, steps, _ = runs
    cfg = get_config("smollm-360m").reduced(**ZERO1_CFG)
    one = Trainer(cfg, run_config(), seq=16, batch=8, lr=3e-3, seed=0,
                  device="cpu")
    losses = [float(one.step(i)["loss"]) for i in range(2)]
    for r in steps:
        for i in range(4):
            assert r[f"loss1.{i}"] == r[f"loss0.{i}"]
        for k in one.params:
            assert np.array_equal(r[f"p4_1.{k}"], r[f"p4_0.{k}"])
            np.testing.assert_allclose(r[f"p2.{k}"], one.params[k].detach().numpy(),
                                       **TOL)
        np.testing.assert_allclose([r["loss1.0"], r["loss1.1"]], losses,
                                   rtol=1e-5)
        assert r["moment_bytes1"] < 0.3 * r["moment_bytes0"]


def test_checkpoint_from_4x1_restores_onto_2x1_one_device_and_jax(runs):
    out, steps, resume = runs
    saved = steps[0]
    for r in resume:                      # (2, 1), ZeRO-1 moments resliced
        assert int(r["restored_at"]) == 2
        for k in (n[3:] for n in r if n.startswith("p2.")):
            assert np.array_equal(r[f"p2.{k}"], saved[f"p2.{k}"])
        for i in (2, 3):                  # the resumed steps follow
            np.testing.assert_allclose(r[f"loss.{i}"], saved[f"loss1.{i}"],
                                       rtol=1e-5)
        for k in (n[3:] for n in r if n.startswith("p4.")):
            np.testing.assert_allclose(r[f"p4.{k}"], saved[f"p4_1.{k}"],
                                       **TOL)
    # the same checkpoint on one device, and in the reference
    cfg = get_config("smollm-360m").reduced(**ZERO1_CFG)
    one = Trainer(cfg, run_config(), seq=16, batch=8, lr=3e-3, seed=0,
                  device="cpu")
    state, at = restore_checkpoint(f"{out}.ck", None, one.state())
    jstate, jat = jckpt.restore_checkpoint(
        f"{out}.ck", None, jax.tree.map(lambda t: np.asarray(t),
                                        _nested_np(one.state())))
    assert at == jat == 2
    for k, v in state["params"].items():
        assert np.array_equal(v.numpy(), saved[f"p2.{k}"])
        assert np.array_equal(np.asarray(_get(jstate["params"], k)),
                              saved[f"p2.{k}"])
        np.testing.assert_array_equal(state["opt"].mu[k].numpy(),
                                      resume[0][f"mu.{k}"])
        np.testing.assert_array_equal(np.asarray(_get(jstate["opt"][1], k)),
                                      resume[0][f"mu.{k}"])


def _nested_np(state):
    def nest(flat):
        tree = {}
        for name, t in flat.items():
            node = tree
            *parents, leaf = name.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.detach().numpy()
        return tree
    opt = state["opt"]
    return {"params": nest(state["params"]),
            "opt": (opt.step.numpy(), nest(opt.mu), nest(opt.nu))}


def _get(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def test_train_launcher_zero1_on_one_process(tmp_path, capsys):
    """``--zero1`` runs on the mesh (1, 1) of one process, where it shards
    nothing: the same losses as without it."""
    common = ["--reduced", "--device", "cpu", "--seq", "16", "--batch", "4",
              "--steps", "3", "--ckpt-every", "100"]
    z = train.main(common + ["--zero1", "--ckpt-dir", str(tmp_path / "a")])
    plain = train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert z["losses"] == plain["losses"] and len(z["losses"]) == 3
    assert "mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert z["trainer"].model.run.use_zero1
