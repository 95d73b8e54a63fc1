"""The plain references: each full forward equals its own token-by-token
recurrence, the weights they draw are the program's, their arithmetic is
the program's plain path at float32, and they import nothing of the
program, of JAX or of the JAX package."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from harness.cell import build_program_cfg
from harness.manifest import Manifest
from test_faasbench_manifest import ROOT

MAN = Manifest(ROOT)
TINY = {
    "smollm-360m": dict(num_hidden_layers=2, hidden_size=96,
                        num_attention_heads=6, num_key_value_heads=2,
                        head_dim=16, intermediate_size=128, vocab_size=256,
                        torch_dtype="float32"),
    "rwkv6-7b": dict(num_hidden_layers=2, hidden_size=64, head_size=16,
                     intermediate_size=128, vocab_size=256,
                     torch_dtype="float32"),
}


def _tiny(name):
    spec = dict(MAN.config(name), **TINY[name])
    return spec, MAN.reference(spec)


@pytest.mark.parametrize("name", sorted(TINY))
def test_forward_equals_recurrence(name):
    spec, ref = _tiny(name)
    w = ref.draw_weights(spec, 5, "cpu")
    toks = torch.randint(0, 256, (1, 24), generator=torch.Generator()
                         .manual_seed(1))
    if name == "smollm-360m":
        full, step = ref.forward(spec, w, toks[0]), ref.decode(spec, w,
                                                                toks[0])
    else:
        full, step = ref.forward(spec, w, toks), ref.decode(spec, w, toks)
        par = ref.forward(spec, w, toks, parallel=True)
        torch.testing.assert_close(par, full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(step, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TINY))
def test_weights_and_arithmetic_are_the_programs(name):
    """The frozen drawing rule gives the program's parameters bit for bit,
    and the reference's logits are the program's plain forward's (float32,
    the plain attention and recurrence)."""
    from repro_torch.models.api import RunConfig, build_model

    spec, ref = _tiny(name)
    model = build_model(build_program_cfg(ref, spec),
                        RunConfig(attn_impl="plain"), device="cpu")
    model.init_params(torch.Generator(device="cpu").manual_seed(9))
    sd = model.state_dict()
    w = ref.draw_weights(spec, 9, "cpu")
    for k, v in w.items():
        assert torch.equal(sd[k if k in sd else f"layers.{k}"], v), k
    toks = torch.randint(0, 256, (1, 64), generator=torch.Generator()
                         .manual_seed(2))
    with torch.no_grad():
        got = model.forward({"tokens": toks})[0]
    want = ref.logits(spec, w, [toks[0]])[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_control_departs():
    spec, ref = _tiny("smollm-360m")
    w = ref.draw_weights(spec, 3, "cpu")
    toks = torch.arange(20)
    a = ref.forward(spec, w, toks)
    b = ref.forward(spec, w, toks, "fp8")
    assert (a - b).abs().max() > 1e-3 * a.abs().max()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "faasbench", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir,
                                                                   f))}
            assert tops <= {"__future__", "math", "typing", "torch"}, (f, tops)
    code = ("import sys; sys.path.insert(0, 'faasbench'); "
            "import reference.transformer, reference.rwkv6; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
