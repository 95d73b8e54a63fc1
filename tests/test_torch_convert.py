"""Parameter conversion: the reference's tree (as numpy) into the port's
state_dict and back — keys, shapes, dtypes, values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models.api import RunConfig as JRun, build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from torch_port_util import jax_tree_to_numpy, reduced_pair  # noqa: E402


def _tree(name, **kw):
    cj, ct = reduced_pair(name, **kw)
    params = jbuild(cj, JRun()).init_params(jax.random.PRNGKey(0))
    return params, jax_tree_to_numpy(params), ct


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-32b", "granite-34b"])
def test_round_trip_keys_shapes_values(name):
    params, tree, ct = _tree(name)
    model = convert.load_params(build_model(ct, device="cpu"), tree)
    sd = model.state_dict()
    flat = convert.flatten_tree(tree)
    assert set(sd) == set(flat)
    assert ("lm_head" in sd) == (not ct.tie_embeddings)
    for k, v in sd.items():
        assert tuple(v.shape) == flat[k].shape, k
        assert v.dtype == torch.float32
        if k.startswith("layers."):
            assert v.shape[0] == ct.n_layers       # stacked leading L axis
    back = convert.to_numpy_tree(sd)
    assert set(back) == set(tree) and set(back["layers"]) == set(
        tree["layers"])
    for k, v in convert.flatten_tree(back).items():
        np.testing.assert_array_equal(v, flat[k])
    assert convert.flatten_tree(convert.unflatten_tree(flat)).keys() \
        == flat.keys()


def test_bf16_leaves_travel_as_float32_exactly():
    """A bf16 model: leaves widen to float32 numpy on the way out of JAX and
    narrow back to the same bf16 bits in the port; norm weights stay fp32."""
    from dataclasses import replace
    params, tree, ct = _tree("smollm-360m")
    cj16 = replace(reduced_pair("smollm-360m")[0], dtype="bfloat16")
    params16 = jbuild(cj16, JRun()).init_params(jax.random.PRNGKey(0))
    tree16 = jax_tree_to_numpy(params16)
    assert tree16["embed"].dtype == np.float32
    model = convert.load_params(
        build_model(replace(ct, dtype="bfloat16"), device="cpu"), tree16)
    sd = model.state_dict()
    assert sd["embed"].dtype == torch.bfloat16
    assert sd["layers.wq"].dtype == torch.bfloat16
    assert sd["layers.ln1"].dtype == torch.float32
    assert sd["final_norm"].dtype == torch.float32
    back = convert.to_numpy_tree(sd)
    np.testing.assert_array_equal(back["embed"], tree16["embed"])
    np.testing.assert_array_equal(back["layers"]["w_down"],
                                  tree16["layers"]["w_down"])


def test_mismatches_raise():
    _, tree, ct = _tree("smollm-360m")
    model = build_model(ct, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError):
        convert.load_params(model, missing)
    wrong = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        convert.load_params(model, wrong)
