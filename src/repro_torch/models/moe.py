"""Mixture-of-Experts FFN (kimi-k2, arctic): the single-device path.

Counterpart of ``repro.models.moe``. Same parameter keys and stacked shapes
(``router`` (L, d, E) in fp32; ``e_gate``/``e_up`` (L, E, d, fe),
``e_down`` (L, E, fe, d); arctic's dense residual ``r_gate``/``r_up``/
``r_down``), same init scales, and ``_local_moe`` step for step:

  1. fp32 router logits (TF32 off whatever the global switch says), softmax,
     top-k with ties to the lower expert index (``lax.top_k``'s order),
     renormalised top-k probabilities;
  2. the ``(T·k,)`` assignments stably sorted by expert and cut to the
     capacity ``C = min(max(int(T·k / n_shards · moe_capacity_factor), k),
     T·k)``: overflow drops, as in the reference;
  3. the grouped GEMM: ``lax.ragged_dot`` (an XLA primitive, not a Pallas
     kernel) becomes ``ops.grouped_swiglu`` for the gate and up products
     with ``silu(gate)·up`` (each product in the model dtype, the epilogue
     in fp32 cast back), then ``ops.grouped_matmul`` for the down
     projection, both routed by ``run.attn_impl``: the hand-written kernels
     read the group sizes on the device (no host synchronisation, so a
     decode step can be captured as a CUDA graph), and the fused pass reads
     the packed rows once for both matrices; the plain forms, which
     training differentiates, loop ``torch.matmul`` over the contiguous
     groups after reading the sizes on the host. The FSDP experts of a
     mesh keep that loop, a chunk of gathered experts at a time; on meta
     tensors (the dry run) the ``C`` rows are split evenly instead, which
     counts the same FLOPs as one product over them and reads every local
     expert once;
  4. the down projection's rows times the renormalised weights, an fp32
     ``index_add_`` back to the token positions.

On a mesh (``moe_ffn(..., mesh=)`` with a model axis of more than one
rank) the experts are sharded over the model axis and the router is
replicated, as in the reference's ``shard_map``: each rank routes every
local token, packs the assignments that target its own experts up to the
capacity ``C = T·k / n_shards · cf`` (overflow drops, so the kept tokens
differ from one device's), runs its experts and returns a partial output
that a ``psum`` over the model axis completes. With
``RunConfig.fsdp_experts`` the experts' FF dimension is also sharded over
the data axes and all-gathered just in time, per layer, a few experts at a
time (``EXPERT_GATHER_BYTES`` bounds what a rank holds gathered: at arctic's
width one expert's three matrices are 209 MB in bf16). arctic's dense
residual runs tensor-parallel (columns, rows, ``psum``) beside it. The
branch trains: the tokens and the router enter through ``copy_to`` (their
gradients summed over the model axis), the partial output leaves through
``psum``, and the FSDP gather is ``all_gather_rs``, whose backward
reduce-scatters the experts' gradients over the data axes (so the train
step only divides those leaves by the data ranks).
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models.sharding import P

EXPERT_GATHER_BYTES = 1 << 30   # gathered expert weights a rank holds at once


def moe_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Per-layer shapes and dtypes of the MoE keys (the model stacks them
    on a leading L axis, as the reference's ``moe_param_specs``)."""
    e = cfg.moe
    d, fe = cfg.d_model, e.d_ff_expert
    dt = torch_dtype(cfg.dtype)
    out = {
        "router": ((d, e.n_experts), torch.float32),
        "e_gate": ((e.n_experts, d, fe), dt),
        "e_up": ((e.n_experts, d, fe), dt),
        "e_down": ((e.n_experts, fe, d), dt),
    }
    if e.dense_residual_ff:
        fr = e.dense_residual_ff
        out.update({"r_gate": ((d, fr), dt), "r_up": ((d, fr), dt),
                    "r_down": ((fr, d), dt)})
    return out


def moe_param_pspecs(cfg: ArchConfig, m: str,
                     fsdp_axes=None) -> Dict[str, P]:
    """Experts sharded over ``m``; with ``fsdp_axes``, the expert FF dim is
    additionally sharded over the data axes (gathered per layer). Keys are
    the per-layer names; the specs include the stacked ``L`` axis."""
    fa = fsdp_axes
    out = {"router": P(None, None, None), "e_gate": P(None, m, None, fa),
           "e_up": P(None, m, None, fa), "e_down": P(None, m, fa, None)}
    if cfg.moe.dense_residual_ff:
        out.update({"r_gate": P(None, None, m), "r_up": P(None, None, m),
                    "r_down": P(None, m, None)})
    return out


@torch.no_grad()
def init_moe_param(generator: torch.Generator, key: str, p: torch.Tensor,
                   full_shape=None, slices=None) -> None:
    """Fill the stacked MoE parameter ``key`` in place, one matrix — a
    (layer, expert) slice of the experts, a layer of the others — at a
    time, in index order from the one generator: a whole fp32 draw of
    arctic's experts would not fit beside them on the card. ``p`` may be
    a rank's part ``slices`` of a tensor of ``full_shape``: every matrix is
    drawn all the same, so the generator runs as on one device and the
    part kept equals that slice of the single-device draw. Scales are the
    reference's: the router N(0, 0.02), every other matrix N(0,
    1/sqrt(fan_in)) with its own fan-in ``shape[-2]``."""
    full = tuple(p.shape if full_shape is None else full_shape)
    slices = tuple(slices) if slices is not None else \
        tuple(slice(0, n) for n in full)
    lead, tail = slices[:-2], slices[-2:]
    scale = 0.02 if key == "router" else 1.0 / math.sqrt(full[-2])
    for idx in itertools.product(*(range(n) for n in full[:-2])):
        m = torch.randn(full[-2:], generator=generator, device=p.device,
                        dtype=torch.float32).mul_(scale)
        if all(s.start <= i < s.stop for i, s in zip(idx, lead)):
            p[tuple(i - s.start for i, s in zip(idx, lead))].copy_(m[tail])


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32: under TF32 a few near-ties of the router would
    pick other experts than the reference's fp32 logits do."""
    prec = torch.get_float32_matmul_precision()
    if prec == "highest":
        return a @ b
    torch.set_float32_matmul_precision("highest")
    try:
        return a @ b
    finally:
        torch.set_float32_matmul_precision(prec)


@dataclass
class Routing:
    """What the router decided for T tokens (C kept assignment rows)."""

    top_p: torch.Tensor         # (T, k) fp32, renormalised
    top_e: torch.Tensor         # (T, k) expert ids
    sel_tok: torch.Tensor       # (C,) token of each row, sorted by expert
    sel_e: torch.Tensor         # (C,) local expert; n_local = not this shard's
    sel_p: torch.Tensor         # (C,) fp32 weight; 0 where not this shard's
    group_sizes: torch.Tensor   # (n_local,) rows of each local expert


def route(cfg: ArchConfig, run_cfg, router: torch.Tensor, x: torch.Tensor,
          *, n_local: int, n_shards: int, shard_id: int) -> Routing:
    """Steps 1-2 of ``_local_moe``: router top-k and capacity-bounded
    packing of the assignments that target this shard's ``n_local``
    experts. x: (T, D)."""
    k = cfg.moe.top_k
    T = x.shape[0]
    logits = _matmul_fp32(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    top_p, top_e = (t[:, :k] for t in torch.sort(probs, dim=-1,
                                                  descending=True,
                                                  stable=True))
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                             # (T*k,)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    first = shard_id * n_local
    mine = (flat_e >= first) & (flat_e < first + n_local)
    local_e = torch.where(mine, flat_e - first,
                          torch.full_like(flat_e, n_local))
    C = max(int(T * k / n_shards * run_cfg.moe_capacity_factor), k)
    C = min(C, T * k)
    sel = torch.argsort(local_e, stable=True)[:C]          # (C,)
    sel_e = local_e[sel]
    sel_p = torch.where(sel_e < n_local, flat_p[sel],
                        torch.zeros_like(flat_p[sel]))
    # bincount's counts without its host sync (on a CUDA tensor
    # torch.bincount reads the maximum back to size its output)
    group_sizes = torch.zeros(n_local + 1, dtype=torch.long,
                              device=x.device).index_add_(
        0, sel_e, torch.ones_like(sel_e))[:n_local]
    return Routing(top_p=top_p, top_e=top_e, sel_tok=flat_tok[sel],
                   sel_e=sel_e, sel_p=sel_p, group_sizes=group_sizes)


def _combine(out: torch.Tensor, r: Routing, T: int, D: int) -> torch.Tensor:
    """Step 4's tail: the rows weighted by their renormalised probability
    and added back to their tokens in fp32: (C, D) -> (T, D)."""
    out = out.float() * r.sel_p[:, None]
    return torch.zeros((T, D), dtype=torch.float32,
                       device=out.device).index_add_(0, r.sel_tok, out)


def _local_moe(cfg: ArchConfig, run_cfg, w, x: torch.Tensor, *,
               n_shards: int, shard_id: int, gather=None) -> torch.Tensor:
    """Per-device MoE computation. x: (T, D) tokens; w experts: (E_local,
    D, Fe). Returns this shard's partial output (T, D) in fp32. With
    ``gather`` (FSDP experts), ``gather(e0, e1)`` returns the full
    (gate, up, down) weights of local experts ``e0 .. e1 - 1``, taken
    ``gather.chunk`` experts at a time; every rank walks every chunk, since
    the gathers are collective."""
    dt = torch_dtype(cfg.dtype)
    T, D = x.shape
    n_local = w["e_gate"].shape[0]
    r = route(cfg, run_cfg, w["router"], x, n_local=n_local,
              n_shards=n_shards, shard_id=shard_id)
    xin = x[r.sel_tok].to(dt)                              # (C, D)
    meta = x.device.type == "meta"
    if not meta and gather is None:
        # the grouped GEMMs over the contiguous expert groups of the sorted
        # rows, gate and up fused with their epilogue; rows past the last
        # group (not this shard's) come out 0
        impl = run_cfg.attn_impl
        h = ops.grouped_swiglu(xin, w["e_gate"], w["e_up"], r.group_sizes,
                               impl=impl)
        return _combine(ops.grouped_matmul(h, w["e_down"], r.group_sizes,
                                           impl=impl), r, T, D)
    # FSDP experts (gathered a chunk at a time) and the dry run loop over
    # the groups; rows past the last group stay 0
    out = torch.zeros((xin.shape[0], D), dtype=dt, device=x.device)
    if meta:
        # no values to route by (a dry run's planning step): the C packed
        # rows split evenly over the local experts, whose FLOPs are one
        # product over the C rows however they split, and every local
        # expert's weights read once (an expert with no rows still counts)
        C = xin.shape[0]
        sizes = [C // n_local + (e < C % n_local) for e in range(n_local)]
    else:
        sizes = r.group_sizes.tolist()                     # host sync
    chunk = n_local if gather is None else gather.chunk
    start = 0
    gathered = []
    for e0 in range(0, n_local, chunk):
        e1 = min(e0 + chunk, n_local)
        wg, wu, wd = (w["e_gate"], w["e_up"], w["e_down"]) \
            if gather is None else gather(e0, e1)
        if gather is not None and wg.requires_grad:
            gathered += [wg, wu, wd]
        off = 0 if gather is None else e0
        for e in range(e0, e1):
            n = sizes[e]
            if n == 0 and not meta:
                continue
            rows = xin[start:start + n]
            g = torch.matmul(rows, wg[e - off])
            u = torch.matmul(rows, wu[e - off])
            h = (F.silu(g.float()) * u.float()).to(dt)
            out[start:start + n] = torch.matmul(h, wd[e - off])
            start += n
    y = _combine(out, r, T, D)
    if gathered:
        # every gather's backward is collective: tie each gathered chunk
        # into the output (with weight 0), so that a rank none of whose
        # rows reached a chunk's experts still runs its reduce-scatter
        y = y + 0.0 * sum(t.sum().float() for t in gathered)
    return y


def _fsdp_gather(run_cfg, w, mesh):
    """The just-in-time gather of FSDP experts over the data axes, or None
    when they are not sharded there."""
    fa = mesh.live_axes(run_cfg.data_axes) if run_cfg.fsdp_experts else ()
    if not fa:
        return None
    full = tuple(w["e_gate"].shape[1:-1]) + (
        w["e_gate"].shape[-1] * mesh.size(fa),)
    one = 3 * math.prod(full) * w["e_gate"].element_size()

    def gather(e0, e1):
        # each data rank runs the experts on its own rows: the backward
        # reduce-scatters the weights' gradients over the data axes
        return (S.all_gather_rs(w["e_gate"][e0:e1], fa, 2, mesh),
                S.all_gather_rs(w["e_up"][e0:e1], fa, 2, mesh),
                S.all_gather_rs(w["e_down"][e0:e1], fa, 1, mesh))

    gather.chunk = max(1, EXPERT_GATHER_BYTES // one)
    return gather


def moe_ffn(cfg: ArchConfig, run_cfg, w, x: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the experts' weighted sum plus, where the
    config has one (arctic), the dense residual swiglu branch. On ``mesh``
    ``x`` is this rank's batch rows, the same on every rank of the model
    axis, and ``w`` holds this rank's experts (and residual columns)."""
    B, S_, D = x.shape
    if mesh is None:
        y = _local_moe(cfg, run_cfg, w, x.reshape(B * S_, D), n_shards=1,
                       shard_id=0).reshape(B, S_, D).to(x.dtype)
        if cfg.moe.dense_residual_ff:
            y = y + L.swiglu(x, w["r_gate"], w["r_up"], w["r_down"])
        return y
    m = run_cfg.model_axis
    # the tokens and the replicated router enter per-rank compute: their
    # gradients are summed over the model axis in the backward
    x = S.copy_to(x, m, mesh)
    w = dict(w, router=S.copy_to(w["router"], m, mesh))
    y = _local_moe(cfg, run_cfg, w, x.reshape(B * S_, D),
                   n_shards=mesh.size(m), shard_id=mesh.index(m),
                   gather=_fsdp_gather(run_cfg, w, mesh))
    y = S.psum(y, m, mesh).reshape(B, S_, D).to(x.dtype)
    if cfg.moe.dense_residual_ff:
        y = y + L.swiglu(x, w["r_gate"], w["r_up"], w["r_down"],
                         functools.partial(S.psum_matmul, axes=m, mesh=mesh))
    return y
