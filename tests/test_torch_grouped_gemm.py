"""Port parity for the grouped GEMM (``kernels/grouped_gemm.py``), the
counterpart of ``lax.ragged_dot``, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there); what is held against the reference's
``jax.lax.ragged_dot`` here is the plain version the wrapper takes on a CPU
tensor, and the per-row oracle of ``ref.py``, on the same numpy inputs from
a seed: 2e-5 in fp32, 2e-2 in bf16 (both sides round the same numpy input,
one bf16 rounding of outputs of magnitude <= ~4). The fused gate/up pass
``grouped_swiglu`` likewise, against two ``ragged_dot`` and the reference's
epilogue. Then the MoE layer's ``_local_moe`` on the ops, at reduced
arctic-480b and kimi-k2, against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_matmul, grouped_matmul_plain, grouped_swiglu,
    grouped_swiglu_plain)
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.api import RunConfig  # noqa: E402
from torch_port_util import as_np, reduced_pair, to_jax, to_torch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (C, K, N, group sizes): empty groups, every row in one group, rows past
# the last group, C a multiple of no tile (8 rows, 8 warps, 32 lanes)
CASES = {
    "empty-groups": (37, 24, 40, [0, 5, 0, 20, 0, 12]),
    "one-group": (37, 24, 40, [0, 0, 37, 0]),
    "rows-past-last": (45, 33, 16, [3, 0, 9, 1]),
    "all-empty": (9, 16, 8, [0, 0, 0]),
    "decode-like": (16, 64, 48, [1, 0, 2, 1, 0, 0, 3, 1, 0, 2, 0, 1, 0, 0,
                                 1, 4]),
}


def _inputs(C, K, N, sizes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, K)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(
        np.float32)
    return x, w, np.asarray(sizes, np.int32)


def _ragged_dot(x, w, sizes, jdt):
    return jax.lax.ragged_dot(to_jax(x, jdt), to_jax(w, jdt),
                              jnp.asarray(sizes))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_ragged_dot(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    C, K, N, sizes = CASES[case]
    x, w, gs = _inputs(C, K, N, sizes)
    want = _ragged_dot(x, w, gs, jdt)
    got = grouped_matmul_plain(to_torch(x, tdt), to_torch(w, tdt),
                               torch.from_numpy(gs))
    assert got.dtype == tdt and got.shape == (C, N)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)
    # rows past the last group are exactly 0, as ragged_dot's
    tail = int(gs.sum())
    assert not as_np(got)[tail:].any() and not as_np(want)[tail:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_ragged_dot(case):
    C, K, N, sizes = CASES[case]
    x, w, gs = _inputs(C, K, N, sizes, seed=1)
    got = ref.grouped_matmul_ref(to_torch(x), to_torch(w),
                                 torch.from_numpy(gs))
    np.testing.assert_allclose(as_np(got),
                               as_np(_ragged_dot(x, w, gs, jnp.float32)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["kernel", "plain", "reference"])
def test_ops_dispatch_agrees(impl):
    """On CPU tensors ``impl="kernel"`` takes the plain version; the
    int64 sizes the router makes and int32 ones give the same rows."""
    x, w, gs = _inputs(*CASES["rows-past-last"], seed=2)
    want = grouped_matmul_plain(to_torch(x), to_torch(w),
                                torch.from_numpy(gs))
    for sizes in (torch.from_numpy(gs), torch.from_numpy(gs).long()):
        got = ops.grouped_matmul(to_torch(x), to_torch(w), sizes, impl=impl)
        np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-5,
                                   rtol=2e-5)


def test_kernel_refuses_grad_and_the_plain_form_differentiates():
    x, w, gs = _inputs(*CASES["empty-groups"], seed=3)
    xt, wt = to_torch(x).requires_grad_(True), to_torch(w)
    with pytest.raises(RuntimeError, match='attn_impl="plain"'):
        grouped_matmul(xt, wt, torch.from_numpy(gs))
    out = ops.grouped_matmul(xt, wt, torch.from_numpy(gs), impl="plain")
    out.sum().backward()
    # a row past the last group takes no gradient
    assert not xt.grad[int(gs.sum()):].any()
    assert xt.grad[:int(gs.sum())].abs().sum() > 0


def _swiglu_inputs(C, K, N, sizes, seed=0):
    x, wg, gs = _inputs(C, K, N, sizes, seed)
    wu = _inputs(C, K, N, sizes, seed + 100)[1]
    return x, wg, wu, gs


def _swiglu_ref(x, wg, wu, sizes, jdt):
    """The reference's h (src/repro/models/moe.py:128-131)."""
    g = _ragged_dot(x, wg, sizes, jdt)
    u = _ragged_dot(x, wu, sizes, jdt)
    return (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
            ).astype(jdt)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_plain_matches_ragged_dot(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    C, K, N, sizes = CASES[case]
    x, wg, wu, gs = _swiglu_inputs(C, K, N, sizes)
    want = _swiglu_ref(x, wg, wu, gs, jdt)
    got = grouped_swiglu_plain(to_torch(x, tdt), to_torch(wg, tdt),
                               to_torch(wu, tdt), torch.from_numpy(gs))
    assert got.dtype == tdt and got.shape == (C, N)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)
    tail = int(gs.sum())
    assert not as_np(got)[tail:].any() and not as_np(want)[tail:].any()


@pytest.mark.parametrize("impl", ["kernel", "plain", "reference"])
def test_swiglu_ops_dispatch_agrees(impl):
    x, wg, wu, gs = _swiglu_inputs(*CASES["decode-like"], seed=7)
    want = _swiglu_ref(x, wg, wu, gs, jnp.float32)
    for sizes in (torch.from_numpy(gs), torch.from_numpy(gs).long()):
        got = ops.grouped_swiglu(to_torch(x), to_torch(wg), to_torch(wu),
                                 sizes, impl=impl)
        np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-5,
                                   rtol=2e-5)


def test_swiglu_kernel_refuses_grad():
    x, wg, wu, gs = _swiglu_inputs(*CASES["empty-groups"], seed=8)
    for i in range(3):
        args = [to_torch(x), to_torch(wg), to_torch(wu)]
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match='attn_impl="plain"'):
            grouped_swiglu(*args, torch.from_numpy(gs))
    assert grouped_swiglu(to_torch(x), to_torch(wg), to_torch(wu),
                          torch.from_numpy(gs)).shape == x.shape[:1] + (
        wg.shape[2],)


def _moe_weights(cfg, seed):
    rng = np.random.default_rng(seed)
    e, d = cfg.moe, cfg.d_model
    shapes = {"router": ((d, e.n_experts), 0.5),
              "e_gate": ((e.n_experts, d, e.d_ff_expert), 0.1),
              "e_up": ((e.n_experts, d, e.d_ff_expert), 0.1),
              "e_down": ((e.n_experts, e.d_ff_expert, d), 0.1)}
    return {k: (rng.standard_normal(s) * sc).astype(np.float32)
            for k, (s, sc) in shapes.items()}


@pytest.mark.parametrize("tokens", [8, 3])
@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_local_moe_on_the_op_matches_jax(name, tokens):
    """A decode step's tokens (8 slots, and 3) through the reference's
    ``_local_moe`` and the port's on the grouped op, kernel routing and
    plain alike."""
    cj, ct = reduced_pair(name)
    w = _moe_weights(ct, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (tokens, ct.d_model)).astype(np.float32)
    want = JM._local_moe(cj, JRun(), {k: jnp.asarray(v)
                                      for k, v in w.items()},
                         jnp.asarray(x), n_shards=1, shard_id=0)
    for impl in ("kernel", "plain"):
        got = TM._local_moe(ct, RunConfig(attn_impl=impl),
                            {k: torch.from_numpy(v) for k, v in w.items()},
                            torch.from_numpy(x), n_shards=1, shard_id=0)
        np.testing.assert_allclose(as_np(got), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_local_moe_reaches_the_op(monkeypatch):
    """One device without FSDP experts makes two grouped launches a layer:
    ``ops.grouped_swiglu`` (gate and up, fused with their epilogue), then
    ``ops.grouped_matmul`` (down), where the reference calls ragged_dot
    three times."""
    _, ct = reduced_pair("arctic-480b")
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(ct, 6).items()}
    calls = []

    def spy(name):
        real = getattr(ops, name)

        def call(*a, **kw):
            calls.append((name, kw.get("impl")))
            return real(*a, **kw)
        return call

    for name in ("grouped_swiglu", "grouped_matmul"):
        monkeypatch.setattr(ops, name, spy(name))
    TM._local_moe(ct, RunConfig(), w, torch.randn(4, ct.d_model),
                  n_shards=1, shard_id=0)
    assert calls == [("grouped_swiglu", "kernel"),
                     ("grouped_matmul", "kernel")]
