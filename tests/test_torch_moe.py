"""Port parity for the MoE layer (``repro_torch.models.moe``) on the CPU in
fp32: the same numpy weights and tokens through the JAX reference's
``_local_moe`` / ``moe_ffn`` and the port's, on reduced arctic-480b (with
its dense residual branch) and kimi-k2 (top-2 after reduction).

The router's decisions are compared exactly, not by a tolerance: the top-k
experts of every token, and under a capacity that drops (factor 0.5) the
kept (token, expert) assignments in their packed order and the group
sizes. The reference's own values are read by spying on the ``lax.top_k``
and ``lax.ragged_dot`` calls its ``_local_moe`` makes. Outputs agree within
2e-5; the serving path's greedy tokens equal the JAX engine's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.api import RunConfig as JRun  # noqa: E402
from repro.serving.engine import Replica as JReplica  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, Replica  # noqa: E402
from repro_torch.serving.exec_cache import ExecutableCache  # noqa: E402
from torch_port_util import as_np, jax_tree_to_numpy, reduced_pair  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
MOE = ["arctic-480b", "kimi-k2-1t-a32b"]
T = 32                      # tokens


def _weights(cfg, seed=0):
    """Router logits of O(1) spread (no near-ties at fp32 round-off), experts
    at 0.1."""
    rng = np.random.default_rng(seed)
    e, d = cfg.moe, cfg.d_model
    shapes = {"router": ((d, e.n_experts), 0.5),
              "e_gate": ((e.n_experts, d, e.d_ff_expert), 0.1),
              "e_up": ((e.n_experts, d, e.d_ff_expert), 0.1),
              "e_down": ((e.n_experts, e.d_ff_expert, d), 0.1)}
    if e.dense_residual_ff:
        fr = e.dense_residual_ff
        shapes.update({"r_gate": ((d, fr), 0.1), "r_up": ((d, fr), 0.1),
                       "r_down": ((fr, d), 0.1)})
    return {k: (rng.standard_normal(s) * sc).astype(np.float32)
            for k, (s, sc) in shapes.items()}


def _x(cfg, *lead, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*lead, cfg.d_model)).astype(np.float32)


def _jax_local_moe(monkeypatch, cfg, cf, w, x):
    """The reference's ``_local_moe`` output, with what it passed to
    ``lax.top_k`` / ``lax.ragged_dot`` recorded on the way."""
    seen = {}
    top_k, ragged_dot = jax.lax.top_k, jax.lax.ragged_dot

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen["top_e"] = np.asarray(out[1])
        return out

    def spy_ragged_dot(lhs, rhs, group_sizes, *a, **kw):
        seen.setdefault("xin", np.asarray(lhs))
        seen.setdefault("group_sizes", np.asarray(group_sizes))
        return ragged_dot(lhs, rhs, group_sizes, *a, **kw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.lax, "ragged_dot", spy_ragged_dot)
    wj = {k: jnp.asarray(w[k]) for k in ("router", "e_gate", "e_up",
                                          "e_down")}
    y = JM._local_moe(cfg, JRun(moe_capacity_factor=cf), wj, jnp.asarray(x),
                      n_shards=1, shard_id=0)
    return np.asarray(y), seen


def _kept_from_jax(seen, x, n_experts):
    """(token, expert) of every packed row the reference kept, in order:
    the token from matching the row of x it gathered, the expert from the
    group sizes (rows are grouped by expert in order)."""
    xin, sizes = seen["xin"], seen["group_sizes"]
    n = int(sizes.sum())
    dist = ((xin[:n, None, :] - x[None, :, :]) ** 2).sum(-1)
    tok = dist.argmin(1)
    assert np.array_equal(xin[:n], x[tok])          # exact gathers
    exp = np.repeat(np.arange(n_experts), sizes)
    return list(zip(tok.tolist(), exp.tolist()))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_local_moe_routing_and_output_match_jax(monkeypatch, name, cf):
    cj, ct = reduced_pair(name)
    w, x = _weights(ct), _x(ct, T)
    want, seen = _jax_local_moe(monkeypatch, cj, cf, w, x)
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    run = RunConfig(moe_capacity_factor=cf)
    E, k = ct.moe.n_experts, ct.moe.top_k
    r = TM.route(ct, run, wt["router"], torch.from_numpy(x), n_local=E,
                 n_shards=1, shard_id=0)
    assert np.array_equal(r.top_e.numpy(), seen["top_e"])
    kept = r.sel_e < E
    assert list(zip(r.sel_tok[kept].tolist(), r.sel_e[kept].tolist())) \
        == _kept_from_jax(seen, x, E)
    assert np.array_equal(r.group_sizes.numpy(), seen["group_sizes"])
    # 1.25 keeps every assignment; 0.5 drops half of them
    assert int(kept.sum()) == (T * k if cf > 1 else T * k // 2)
    got = TM._local_moe(ct, run, wt, torch.from_numpy(x), n_shards=1,
                        shard_id=0)
    assert got.dtype == torch.float32 and got.shape == (T, ct.d_model)
    np.testing.assert_allclose(as_np(got), want, **TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_jax(name):
    """The whole layer: (B, S, D) in, the experts plus arctic's dense
    residual swiglu out."""
    cj, ct = reduced_pair(name)
    w, x = _weights(ct, seed=2), _x(ct, 2, 16, seed=3)
    want = JM.moe_ffn(cj, JRun(), {k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(x))
    got = TM.moe_ffn(ct, RunConfig(), {k: torch.from_numpy(v)
                                       for k, v in w.items()},
                     torch.from_numpy(x))
    assert got.shape == (2, 16, ct.d_model)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_router_ties_go_to_the_lower_expert_as_in_jax(monkeypatch):
    """Experts 1 and 5 (and 2 and 6) have the same router column, so every
    token sees exact ties; lax.top_k takes the lower index first and so
    must the port (torch.topk promises no order among equals)."""
    cj, ct = reduced_pair("kimi-k2-1t-a32b")
    w = _weights(ct, seed=4)
    w["router"][:, [1, 2]] += 1.0          # make the tied pairs the top two
    w["router"][:, 5] = w["router"][:, 1]
    w["router"][:, 6] = w["router"][:, 2]
    x = np.abs(_x(ct, T, seed=5))
    _, seen = _jax_local_moe(monkeypatch, cj, 1.25, w, x)
    r = TM.route(ct, RunConfig(), torch.from_numpy(w["router"]),
                 torch.from_numpy(x), n_local=ct.moe.n_experts, n_shards=1,
                 shard_id=0)
    assert np.array_equal(r.top_e.numpy(), seen["top_e"])
    pairs = {tuple(row) for row in seen["top_e"].tolist()}
    assert pairs == {(1, 5), (2, 6)}       # tied pairs, lower index first


def test_router_runs_in_full_fp32_and_restores_the_precision():
    """The router product is taken at 'highest' matmul precision whatever
    the caller set, and the caller's setting is left as it was."""
    _, ct = reduced_pair("arctic-480b")
    w, x = _weights(ct), torch.from_numpy(_x(ct, T))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        r = TM.route(ct, RunConfig(), torch.from_numpy(w["router"]), x,
                     n_local=ct.moe.n_experts, n_shards=1, shard_id=0)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    ref = TM.route(ct, RunConfig(), torch.from_numpy(w["router"]), x,
                   n_local=ct.moe.n_experts, n_shards=1, shard_id=0)
    assert torch.equal(r.top_e, ref.top_e) and torch.equal(r.top_p, ref.top_p)


def test_moe_init_scales_pieces_and_determinism():
    """Router N(0, 0.02) in fp32 whatever the model dtype, every other MoE
    matrix N(0, 1/sqrt(its own fan-in)) — not the stacked-shape rule of the
    dense keys — drawn a matrix at a time from the one generator, so equal
    seeds give equal weights. No dense MLP keys in a MoE layer."""
    cfg = dataclasses.replace(
        get_config("arctic-480b").reduced(n_layers=3, d_model=256,
                                          d_ff=64),
        dtype="bfloat16")
    m1 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(9))
    m2 = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(9))
    sd = m1.state_dict()
    assert all(torch.equal(v, m2.state_dict()[k]) for k, v in sd.items())
    assert not {"layers.w_gate", "layers.w_up", "layers.w_down"} & set(sd)
    assert sd["layers.router"].dtype == torch.float32
    assert sd["layers.router"].shape == (3, 256, 8)
    assert sd["layers.e_gate"].dtype == torch.bfloat16
    assert sd["layers.e_down"].shape == (3, 8, 64, 256)
    std = {k: float(v.float().std()) for k, v in sd.items()}
    assert abs(std["layers.router"] - 0.02) < 2e-3
    for k, fan_in in (("e_gate", 256), ("e_up", 256), ("e_down", 64),
                      ("r_gate", 256), ("r_down", 64)):
        assert abs(std[f"layers.{k}"] * fan_in ** 0.5 - 1) < 0.05, k
    # the dense keys keep the reference's stacked rule (fan_in = L)
    assert abs(std["layers.wq"] * 3 ** 0.5 - 1) < 0.05
    # one draw a matrix, in index order: the first expert of the first
    # layer is the generator's first e_gate-sized draw after the keys before
    g = torch.Generator().manual_seed(9)
    for k, p in m1.layers.items():
        if k == "e_gate":
            first = torch.randn(p.shape[-2:], generator=g) * 256 ** -0.5
            assert torch.equal(p[0, 0], first.to(p.dtype))
            break
        if k == "router":
            for _ in range(p.shape[0]):
                torch.randn(p.shape[-2:], generator=g)
        elif not (k.startswith("ln") or k.endswith("norm")
                or k.startswith("b_")):
            torch.randn(p.shape, generator=g)


@pytest.mark.parametrize("family,name", [("moe", "arctic-480b"),
                                         ("moe", "kimi-k2-1t-a32b"),
                                         ("vlm", "qwen2-vl-72b")])
def test_build_model_builds_the_moe_and_vlm_families(family, name):
    cfg = get_config(name).reduced()
    assert cfg.family == family
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == "DecoderLM"
    assert ("layers.router" in model.state_dict()) == (family == "moe")
    skeleton = build_model(cfg, device="meta")
    assert skeleton.layers["wq"].is_meta


# -- the serving path ------------------------------------------------------------

@pytest.fixture(scope="module")
def arctic_pair():
    """(jax replica, torch replica) of reduced arctic-480b on the same
    weights."""
    cj, ct = reduced_pair("arctic-480b")
    jrep = JReplica(cj, max_seq=64)
    trep = Replica(ct, max_seq=64, exec_cache=ExecutableCache(), device="cpu")
    convert.load_params(trep.model, jax_tree_to_numpy(jrep.params))
    return jrep, trep


PROMPTS = [[1, 2, 3, 4], [5, 6], [7, 8, 9], [11, 12]]


def test_moe_batcher_greedy_tokens_equal_jax_generate(arctic_pair):
    """An MoE DecoderLM serves through the port's ContinuousBatcher as it
    is: four requests, one admitted mid-flight, idle slots stepped beside
    them; each request's tokens equal the JAX Replica.generate of its
    prompt alone."""
    jrep, trep = arctic_pair
    cb = ContinuousBatcher(trep, max_slots=4)
    rids = [cb.add_request(p, max_new=6) for p in PROMPTS[:3]]
    for _ in range(3):
        cb.step()
    rids.append(cb.add_request(PROMPTS[3], max_new=6))
    cb.run_until_done()
    for p, rid in zip(PROMPTS, rids):
        assert cb.finished[rid] == jrep.generate(p, max_new_tokens=6), p


def test_moe_greedy_margin_is_wide(arctic_pair):
    """The seed's guarantee behind the test above: at every generated
    position the top two logits are far apart against the ~1e-5
    cross-framework difference, so no argmax tie can flip a token."""
    _, trep = arctic_pair
    gaps = []
    for prompt in PROMPTS:
        cache = trep.new_cache(1)
        toks = list(prompt)
        for t in range(len(prompt) + 6):
            logits, cache = trep._decode(cache, {
                "tokens": torch.tensor([[toks[t]]], dtype=torch.int32),
                "cache_len": t})
            if t >= len(prompt) - 1:
                top = torch.topk(logits[0], 2).values
                gaps.append(float(top[0] - top[1]))
                toks.append(int(logits[0].argmax()))
    assert min(gaps) > 1e-3
