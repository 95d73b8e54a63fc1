"""The fused passes of DecoderLM's decode step (``kernels/fused_decode.py``)
on the CPU: each plain form is the composition it replaces, bit for bit;
the fused route of ``DecoderLM.decode_step`` gives the unfused route's
logits and caches bit for bit; the route is taken only where its predicate
says; the wrappers refuse grad, raise off the CPU and check the shapes
their kernels take. The kernels themselves run on the card only
(``chip_smoke.py``)."""
import dataclasses
import os
import re
import types

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import build, fused_decode as fd, ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
DTYPES = [torch.float32, torch.bfloat16]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(g, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype)


# -- the plain forms against the compositions they replace ---------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,d", [(64, 960), (3, 128), (2, 8192)])
def test_add_rms_norm_plain_is_the_add_then_rms_norm(b, d, dtype):
    g = _gen(d)
    x, delta = (_randn(g, b, 1, d, dtype=dtype, scale=2.0) for _ in range(2))
    w = _randn(g, d, scale=0.3) + 1.0
    got_x, got_h = fd.add_rms_norm_plain(x, delta, w)
    want_x = x + delta
    assert torch.equal(got_x, want_x) and got_x.dtype == dtype
    assert torch.equal(got_h, L.rms_norm(want_x, w))
    # the first layer's norm: nothing added, x handed back
    first_x, first_h = fd.add_rms_norm_plain(x, None, w)
    assert first_x is x and torch.equal(first_h, L.rms_norm(x, w))
    # the wrapper and ops take the plain form on CPU tensors
    for impl in ("kernel", "plain", "reference"):
        ox, oh = ops.add_rms_norm(x, delta, w, impl=impl)
        assert torch.equal(ox, want_x) and torch.equal(oh, got_h)


# smollm-360m's 15 / 5 heads of 64, a group of 7 at head dim 128 (arctic),
# an MHA row, and M-RoPE tables (qwen2-vl's sections at head dim 128)
ROPE_CASES = {
    "smollm": dict(b=64, hq=15, hkv=5, d=64, smax=1024, mrope=None),
    "g7-d128": dict(b=4, hq=56, hkv=8, d=128, smax=40, mrope=None),
    "mha-d32": dict(b=3, hq=4, hkv=4, d=32, smax=9, mrope=None),
    "mrope-d128": dict(b=4, hq=8, hkv=1, d=128, smax=33,
                       mrope=(16, 24, 24)),
}


def _rope_inputs(b, hq, hkv, d, smax, mrope, dtype, seed=0):
    g = _gen(seed)
    q = _randn(g, b, 1, hq, d, dtype=dtype)
    k = _randn(g, b, 1, hkv, d, dtype=dtype)
    v = _randn(g, b, 1, hkv, d, dtype=dtype)
    ck = _randn(g, b, smax, hkv, d, dtype=dtype)
    cv = _randn(g, b, smax, hkv, d, dtype=dtype)
    # a row at length 0, one at the cache's last position, a freed row at
    # its stale length (written all the same), the rest anywhere
    lens = torch.randint(0, smax, (b,), generator=g)
    lens[0], lens[-1] = 0, smax - 1
    pos = lens[:, None].to(torch.int32)
    if mrope is None:
        cos, sin = L.rope_tables(pos, d, 10000.0)
    else:
        cos, sin = L.mrope_tables(torch.stack([pos, pos, pos], -1), d, mrope,
                                  10000.0)
    return q, k, v, cos, sin, ck, cv, lens.long()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_kv_write_plain_is_rotate_then_index_put(case, dtype):
    q, k, v, cos, sin, ck, cv, lens = _rope_inputs(**ROPE_CASES[case],
                                                   dtype=dtype)
    assert cos.shape == (q.shape[0], 1, 1, q.shape[-1] // 2)
    want_k, want_v = ck.clone(), cv.clone()
    rows = torch.arange(q.shape[0])
    want_k.index_put_((rows, lens), L.rotate(k, cos, sin)[:, 0])
    want_v.index_put_((rows, lens), v[:, 0])
    want_q = L.rotate(q, cos, sin)
    for impl in ("plain", "kernel"):
        got_k, got_v = ck.clone(), cv.clone()
        got_q = ops.rope_kv_write(q, k, v, cos, sin, got_k, got_v, lens,
                                  impl=impl)
        assert torch.equal(got_q, want_q) and got_q.dtype == dtype
        assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    # each row's own position moved, and nothing else
    own = torch.zeros(ck.shape[:2], dtype=torch.bool)
    own[rows, lens] = True
    assert not ((want_k != ck).any(-1).any(-1) & ~own).any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(64, 1, 2560), (3, 1, 24)])
def test_silu_mul_plain_is_silu_times_up(shape, dtype):
    g = _gen(7)
    gate = _randn(g, *shape, dtype=dtype, scale=3.0)
    up = _randn(g, *shape, dtype=dtype)
    want = F.silu(gate) * up
    for impl in ("kernel", "plain", "reference"):
        got = ops.silu_mul(gate, up, impl=impl)
        assert torch.equal(got, want) and got.dtype == dtype


def test_no_kernel_launches_and_unknown_impls_raise_on_the_cpu():
    x = torch.ones(2, 1, 8)
    w = torch.ones(8)
    before = ops.launch_counts()
    ops.add_rms_norm(x, x, w)
    ops.silu_mul(x, x)
    assert ops.launch_counts() == before
    for name in ("add_rms_norm", "rope_kv_write", "silu_mul"):
        assert name in before
    with pytest.raises(ValueError):
        ops.add_rms_norm(x, x, w, impl="auto")
    with pytest.raises(ValueError):
        ops.silu_mul(x, x, impl="pallas")
    q, k, v, cos, sin, ck, cv, lens = _rope_inputs(**ROPE_CASES["mha-d32"],
                                                   dtype=torch.float32)
    with pytest.raises(ValueError):
        ops.rope_kv_write(q, k, v, cos, sin, ck, cv, lens, impl="fused")


# -- DecoderLM: the fused route against the unfused one ------------------------

# tiny configurations of the families on the fused route: dense (a group
# of three query heads, as smollm-360m's 15 : 5), qk-norm, M-RoPE, MoE with
# arctic's dense residual, and a GELU MLP (kernel 3 not engaged)
FAMILIES = {
    "smollm-360m": dict(n_heads=6, n_kv_heads=2, d_model=96),
    "smollm-360m/bf16": dict(n_heads=6, n_kv_heads=2, d_model=96),
    "qwen3-32b": {},
    "qwen2-vl-72b": {},
    "arctic-480b": {},
    "granite-34b": {},
}


def _model(key):
    name, _, tag = key.partition("/")
    cfg = get_config(name).reduced(**FAMILIES[key])
    if tag == "bf16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    model.init_params(_gen(11), layer_fan_in=True)
    return model


def _decode(model, steps, b=4, smax=16, seed=3):
    """``steps`` decode steps from a seeded cache with per-row lengths (a
    row idle at length 0, a row at a stale length); the logits of each
    and the caches after."""
    g = _gen(seed)
    cache = model.init_cache(ShapeSpec("t", smax, b, "decode"))
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype) * 0.5)
    toks = torch.randint(0, model.cfg.vocab, (b, steps), generator=g)
    lens = torch.tensor([0, 3, 7, 5])[:b]
    logits = []
    with torch.inference_mode():
        for s in range(steps):
            step_lens = lens + torch.tensor([0, s, s, 0])[:b]  # 0, 3: idle
            out, cache = model.decode_step(cache, {
                "tokens": toks[:, s:s + 1], "cache_len": step_lens})
            logits.append(out.clone())
    return logits, cache


class _Counted:
    """Spies on ops' fused passes: how many calls a route made."""

    def __init__(self, monkeypatch):
        self.calls = {"add_rms_norm": 0, "rope_kv_write": 0, "silu_mul": 0}
        for name in self.calls:
            real = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._spy(name, real))

    def _spy(self, name, real):
        def call(*a, **kw):
            self.calls[name] += 1
            return real(*a, **kw)
        return call


@pytest.mark.parametrize("key", list(FAMILIES))
def test_fused_decode_step_is_the_unfused_step_bit_for_bit(key, monkeypatch):
    model = _model(key)
    cfg, steps = model.cfg, 8
    spy = _Counted(monkeypatch)
    fused, fused_cache = _decode(model, steps)
    dense_swiglu = cfg.moe is None and cfg.mlp == "swiglu"
    assert spy.calls == {"add_rms_norm": steps * (2 * cfg.n_layers + 1),
                         "rope_kv_write": steps * cfg.n_layers,
                         "silu_mul": steps * cfg.n_layers * dense_swiglu}
    monkeypatch.setattr(DecoderLM, "_use_fused_decode",
                        lambda self, cache_len: False)
    plain, plain_cache = _decode(model, steps)
    assert spy.calls["rope_kv_write"] == steps * cfg.n_layers  # no more
    for a, b in zip(fused, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name in ("k", "v"):
        assert torch.equal(fused_cache[name], plain_cache[name])


def test_predicate_takes_the_fused_route_only_where_it_holds():
    model = _model("smollm-360m")
    assert model._use_fused_decode(torch.tensor([1, 2]))
    assert not model._use_fused_decode(torch.tensor(3))       # scalar
    model.mesh = types.SimpleNamespace()                       # on a mesh
    assert not model._use_fused_decode(torch.tensor([1, 2]))
    model.mesh = None
    model.cfg = dataclasses.replace(model.cfg, norm="layernorm")
    assert not model._use_fused_decode(torch.tensor([1, 2]))


def test_scalar_length_decode_takes_the_unfused_route(monkeypatch):
    model = _model("smollm-360m")
    spy = _Counted(monkeypatch)
    cache = model.init_cache(ShapeSpec("t", 8, 2, "decode"))
    with torch.inference_mode():
        model.decode_step(cache, {"tokens": torch.tensor([[1], [2]]),
                                  "cache_len": 3})
    assert spy.calls == {"add_rms_norm": 0, "rope_kv_write": 0,
                         "silu_mul": 0}


# -- the wrappers ---------------------------------------------------------------

def _calls(make):
    """Each wrapper called on tensors from ``make(*shape, dtype=...)``."""
    f32 = torch.float32
    x, w = make(2, 1, 16), make(16, dtype=f32)
    q, k = make(2, 1, 4, 8), make(2, 1, 2, 8)
    cos, cache = make(2, 1, 1, 4, dtype=f32), make(2, 5, 2, 8)
    lens = make(2, dtype=torch.int64)
    return {"add_rms_norm": lambda: fd.add_rms_norm(x, x, w),
            "rope_kv_write": lambda: fd.rope_kv_write(
                q, k, k, cos, cos, cache, cache.clone(), lens),
            "silu_mul": lambda: fd.silu_mul(x, x)}


@pytest.mark.parametrize("name", ["add_rms_norm", "rope_kv_write",
                                  "silu_mul"])
def test_wrappers_refuse_grad_and_take_the_plain_form_on_the_cpu_only(name):
    import inspect

    def grad(*shape, dtype=torch.float32):
        if dtype == torch.int64:
            return torch.zeros(shape, dtype=dtype)
        return torch.zeros(shape, dtype=dtype, requires_grad=True)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(RuntimeError, match="requires grad"):
        _calls(grad)[name]()
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no kernel for device"):
        _calls(meta)[name]()
    assert ops.launch_counts() == before
    src = inspect.getsource(getattr(fd, name))
    assert "try:" not in src and "except" not in src


def test_checks_raise_on_what_the_kernels_do_not_take():
    bf = torch.bfloat16
    w = torch.ones(960)
    x = torch.zeros(4, 1, 960, dtype=bf)
    fd._check_norm(x, x, w)
    fd._check_norm(x, None, w)
    with pytest.raises(ValueError, match="hidden size"):
        fd._check_norm(torch.zeros(4, 1, 36), None, torch.ones(36))
    with pytest.raises(ValueError, match="hidden size"):
        fd._check_norm(torch.zeros(1, 40000, dtype=bf), None,
                       torch.ones(40000))
    with pytest.raises(TypeError):
        fd._check_norm(x, x, w.to(bf))                 # weight not fp32
    with pytest.raises(TypeError):
        fd._check_norm(x.half(), None, w)
    with pytest.raises(ValueError, match="contiguous"):
        fd._check_norm(x, torch.zeros(4, 1, 1920, dtype=bf)[..., ::2], w)
    with pytest.raises(ValueError, match="aligned"):
        fd._check_norm(torch.zeros(4 * 960 + 1, dtype=bf)[1:].view(4, 960),
                       None, w)

    args = list(_rope_inputs(**ROPE_CASES["g7-d128"], dtype=bf))
    fd._check_rope(*args)
    bad = {0: args[0][..., :100],                      # head dims differ
           3: args[3][..., :8].contiguous(),           # tables too short
           5: args[5][:, :, :4].contiguous(),          # cache heads
           7: args[7].int(),                           # lengths not int64
           1: args[1].float()}                         # dtypes differ
    for i, t in bad.items():
        with pytest.raises((ValueError, TypeError)):
            fd._check_rope(*[t if j == i else a for j, a in enumerate(args)])
    odd = _rope_inputs(b=2, hq=2, hkv=1, d=130, smax=4, mrope=None,
                       dtype=bf)
    with pytest.raises(ValueError, match="head dim"):
        fd._check_rope(*odd)

    g = torch.zeros(2, 1, 2560, dtype=bf)
    fd._check_silu(g, g)
    with pytest.raises(ValueError):
        fd._check_silu(torch.zeros(3, 1, 5), torch.zeros(3, 1, 5))
    with pytest.raises(ValueError):
        fd._check_silu(g, g[:1])


def test_kernel_source_is_plain_cuda_with_its_three_entry_points():
    """Hand-written CUDA C++ with a plain C interface (no PyTorch headers,
    no library kernels), naming what it replaces; no kernel name contains
    the names the benchmark's readers match as substrings."""
    with open(os.path.join(CSRC, "fused_decode.cu")) as fh:
        text = fh.read()
    for entry in ("repro_add_rms_norm", "repro_rope_kv_write",
                  "repro_silu_mul"):
        assert f'extern "C" int {entry}(' in text
    assert "torch/" not in text and "ATen" not in text
    assert "cublas" not in text.lower() and "cutlass" not in text.lower()
    assert "src/repro/models/layers.py" in text
    kernels = re.findall(
        r"__global__ void (?:__launch_bounds__\(\w+\) )?(\w+)\(", text)
    assert kernels == ["add_rms_norm_kernel", "rope_kv_write_kernel",
                       "silu_mul_kernel"]
    for name in kernels:
        assert "decode_attention_kernel" not in name
        assert "wkv6_decode_kernel" not in name


def test_every_launcher_has_its_argument_types_declared():
    """ctypes passes an undeclared pointer as a 32-bit int: every
    ``extern "C"`` function of the sources gets argtypes and restype."""
    declared = {}

    class Lib:
        def __getattr__(self, name):
            return declared.setdefault(name, types.SimpleNamespace())

    build._declare(Lib())
    entries = set()
    for name in os.listdir(CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(CSRC, name)) as fh:
                entries |= set(re.findall(
                    r'extern "C" [\w ]+?\*? ?(repro_\w+)\(', fh.read()))
    assert {"repro_add_rms_norm", "repro_rope_kv_write",
            "repro_silu_mul"} <= entries
    assert entries == set(declared)
    for name, fn in declared.items():
        assert hasattr(fn, "restype") and hasattr(fn, "argtypes"), name
