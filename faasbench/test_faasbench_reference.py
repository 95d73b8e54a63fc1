"""The plain references: each full forward equals its own token-by-token
recurrence, the weights they draw are the program's, their arithmetic is
the program's plain path at float32, and they import nothing of the
program, of JAX or of the JAX package; the program's config built from a
reference's fields, by ``ArchConfig`` or by the callable they name."""
import ast
import os
import subprocess
import sys
from types import SimpleNamespace

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


class _Stub:
    """A program config that ``ArchConfig`` is not."""

    def __init__(self, **kw):
        self.kw = kw


def _bridge(target, **kw):
    return SimpleNamespace(FAMILY="mla", arch_kwargs=lambda spec: dict(
        kw, program_config=target))


def test_program_config_default_and_named():
    """Naming ``ArchConfig`` gives what the default path gives; a stub put
    into a module of the program gets its own object back, built from the
    other fields."""
    import repro_torch.configs.base as base

    for name in sorted(TINY):
        spec, ref = _tiny(name)
        got = build_program_cfg(_bridge("repro_torch.configs.base:ArchConfig",
                                        **ref.arch_kwargs(spec)), spec)
        assert isinstance(got, base.ArchConfig)
        assert got == build_program_cfg(ref, spec)


def test_program_config_reaches_the_live_spec(monkeypatch):
    """The object the named callable returns is the one the run's
    ``LiveFunctionSpec`` is given."""
    import repro_torch.live as live
    import repro_torch.models.api as api
    from harness.cell import run_cell

    made, seen = [], []

    def latent(**kw):
        made.append(_Stub(**kw))
        return made[-1]

    class Reached(Exception):
        pass

    def spec(cfg, **kw):
        seen.append(cfg)
        raise Reached

    monkeypatch.setattr(api, "LatentConfig", latent, raising=False)
    monkeypatch.setattr(live, "LiveFunctionSpec", spec)
    ref = _bridge("repro_torch.models.api:LatentConfig", n_layers=3)
    assert build_program_cfg(ref, {}) is made[0]
    assert made[0].kw == {"n_layers": 3}
    with pytest.raises(Reached):
        run_cell({}, MAN.traffic("closed"), ref, 1, 1.0, False, 0.0,
                 device="cpu")
    assert len(made) == 2 and len(seen) == 1 and seen[0] is made[1]


@pytest.mark.parametrize("target", [
    "repro.configs.base:ArchConfig", "torch.nn:Linear",
    "repro_torchx.configs:ArchConfig", "repro_torch.configs.base",
    "repro_torch.configs.base:"])
def test_program_config_outside_the_program_raises(target):
    with pytest.raises(ValueError, match="program_config"):
        build_program_cfg(_bridge(target, n_layers=1), {})
