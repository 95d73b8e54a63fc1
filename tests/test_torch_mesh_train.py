"""Training on a model axis above one rank, against the reference.

The port's collectives carry their gradients (``models/sharding.py``), so
``make_train_step`` trains tensor- and expert-parallel. Every family's
reduced config (4 heads, vocabulary 512, zamba2's 296-column ``in_proj``
split 74 a rank across its head boundaries) gets the same numpy weights on
both sides (``mf_inputs``). The reference runs on four fake CPU devices
in a subprocess: ``jax.value_and_grad`` of its ``loss_fn`` jitted with the
shardings of its specs on (1, 4), and one step of its own
``launch.steps.build_step(..., "train_4k", ...)``. The port runs on a gloo
group of four CPU processes through ``repro_torch.launch.steps.build_step``.
The two sides run at the same time, once for the module. Tolerances: the
gradients tests/test_torch_train.py's (``assert_grads_close``, rtol 1e-3 /
atol 1e-4), the loss rtol 1e-5 and the parameters after a step atol 1e-4 /
rtol 1e-3 (tests/test_train.py's), the latter where the gradient is at
least 100 · AdamW's eps: below it the first update g / (|g| + eps) turns a
round-off change of g into a fraction of the learning rate (PERF.md §6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from torch_port_util import (MF_NAMES, MF_STEP_CASES,  # noqa: E402
                             assert_grads_close, finish, mf_inputs,
                             port_mesh_train_job, spawn_gloo, start_jax_mesh)

ADAMW_EPS = 1e-8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs = str(tmp / "inputs.npz")
    mf_inputs(inputs)
    jax_proc = start_jax_mesh("jax_mesh_train_main", 4, inputs,
                              str(tmp / "jax.npz"))
    try:
        spawn_gloo(port_mesh_train_job, 4, tmp, inputs, str(tmp / "port"),
                   str(tmp / "ckpt"), timeout=600)
    finally:
        out = finish(jax_proc, timeout=600)
    assert "jax mesh train ok" in out
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"port.{r}.npz")) for r in range(4)],
            tmp / "ckpt")


def _part(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", MF_NAMES)
def test_tensor_parallel_loss_and_grads_match_jax(runs, name):
    """(1, 4): every rank's loss and gradients (gathered by spec; a
    replicated leaf's as the rank holds it) against ``jax.grad`` of the
    reference's ``loss_fn`` on its mesh."""
    ref, port, _ = runs
    want = _part(ref, f"{name}|g|")
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{name}|loss"],
                                   ref[f"{name}|loss"], rtol=1e-5)
        assert_grads_close(_part(port[r], f"{name}|g|"), want)


@pytest.mark.parametrize("name", MF_NAMES)
def test_families_hold_only_their_shards(runs, name):
    """Built inside ``use_mesh`` on (1, 4), every parameter has its
    ``local_shape``: no family computes a replicated model unnoticed."""
    for r in range(4):
        held = _part(runs[1][r], f"{name}|local|")
        assert held and all(bool(v) for v in held.values())


STEP_CASES = [(n, shape, over) for n, cases in MF_STEP_CASES.items()
              for shape, over in cases]


@pytest.mark.parametrize("name,shape,over", STEP_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s, _ in STEP_CASES])
def test_adamw_step_on_the_mesh_matches_build_step(runs, name, shape, over):
    """One step of the port's ``build_step(..., "train_4k", ...)`` against
    the reference's on the same mesh: loss, the clip's global norm
    (TP leaves summed over their axes, ZeRO-1 moments over data), and the
    parameters. (2, 2) runs ZeRO-1, arctic's with FSDP experts (the
    gather's reduce-scatter sums their gradients over data)."""
    ref, port, _ = runs
    key = f"{name}|{shape[0]}x{shape[1]}"
    grads = _part(ref, f"{name}|g|")
    want = _part(ref, f"{key}|p|")
    assert float(ref[f"{key}|gnorm"]) > 1.0       # the clip is active
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{key}|loss"],
                                   ref[f"{key}|loss"], rtol=1e-5)
        np.testing.assert_allclose(port[r][f"{key}|gnorm"],
                                   ref[f"{key}|gnorm"], rtol=1e-4)
        got = _part(port[r], f"{key}|p|")
        assert set(got) == set(want)
        for k, w in want.items():
            tight = np.abs(grads[k]) >= 100 * ADAMW_EPS
            np.testing.assert_allclose(got[k][tight], w[tight], atol=1e-4,
                                       rtol=1e-3, err_msg=k)


def test_tensor_parallel_checkpoint_restores_on_one_device(runs):
    """The (1, 4) step's checkpoint (gathered by spec, rank 0 writes)
    restored on one device: the parameters and moments bit for bit."""
    _, port, ckpt = runs
    cfg = get_config("qwen3-32b").reduced()
    model = build_model(cfg, RunConfig(), device="cpu")
    params = dict(model.named_parameters())
    state, at = restore_checkpoint(str(ckpt), None, {
        "params": params, "opt": adamw_init(params)})
    assert at == 1
    for k, v in state["params"].items():
        assert np.array_equal(v.numpy(), port[0][f"qwen3-32b|1x4|p|{k}"]), k
        assert np.array_equal(state["opt"].mu[k].numpy(),
                              port[0][f"ckpt|mu|{k}"]), k


def test_adamw_update_in_row_blocks_is_bit_equal(monkeypatch):
    """The update walks a leaf a block of rows at a time (its temporaries
    bounded at full width); blocks of 7 elements, so every leaf splits,
    give the whole-leaf update bit for bit."""
    from repro_torch.train import optimizer as O
    rng = np.random.default_rng(3)
    shapes = {"w": (12, 5), "v": (9,), "s": ()}

    def run():
        params = {k: torch.from_numpy(rng_p[k].copy()) for k in shapes}
        state = adamw_init(params)
        for g in grads:
            O.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                           state, params, lr=1e-2, grad_clip=0.5)
        return params, state

    rng_p = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    whole = run()
    monkeypatch.setattr(O, "_BLOCK", 7)
    assert len(O._row_blocks(torch.zeros(12, 5))) == 12
    blocks = run()
    for a, b in ((whole[0], blocks[0]), (whole[1].mu, blocks[1].mu),
                 (whole[1].nu, blocks[1].nu)):
        for k in shapes:
            assert torch.equal(a[k], b[k]), k
