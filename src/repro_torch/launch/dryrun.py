"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
on meta tensors.

Counterpart of ``repro.launch.dryrun``. The reference proves a cell
coherent by lowering and compiling it for 256 or 512 fake XLA devices and
records what §Roofline consumes: ``memory_analysis``, ``cost_analysis``
(FLOPs, bytes) and the collectives parsed from the optimized HLO. Eager
PyTorch compiles nothing, so here the cell's proof is rank 0 running its
step: a ``torch.distributed`` default group of the mesh's world on the
``fake`` backend (``FakeStore``: collectives return at once, nothing is
sent), the production mesh over it (``make_production_mesh``), the model
built on the mesh with this rank's shards, and every tensor on the
``meta`` device, which carries shapes and no values: a step of
qwen3-32b x train_4k takes seconds and no memory. The step runs with
``attn_impl="plain"`` (a kernel wrapper handed a meta tensor raises, as it
does for any device it cannot serve). Every shape, layout and collective
of the step is exercised; no value is.

What a cell records, in the reference's JSON layout (``status``,
``memory``, ``cost``, ``run_cfg``):

  * ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matrix
    products and attention, as the card's tensor cores run them; no
    elementwise work);
  * ``cost.bytes_accessed``: each computing op's operands and results
    (views and allocations count 0): an unfused count, so an upper bound
    of the card's memory traffic;
  * ``cost.collectives``: the collective log (``launch/collectives.py``);
  * ``memory``: argument bytes exactly from the local shapes (parameters,
    optimizer state, inputs, cache), output and aliased bytes from what
    the step returns and updates in place, and temp bytes as the peak of
    live bytes of the storages the step makes.

**Probes.** The costs come from the reference's affine probe solver
(``_probe_variants``): every layer stack is homogeneous, so a rank's cost
is ``fixed + L * per_layer``, solved from traces at 1 and 2 layers
(``attn_every`` and twice that for the hybrid, three probes for Whisper's
two stacks). The reason here is the trace's time, not a scan body counted
once: a full-depth trace of qwen3-32b x prefill_32k did not finish in
100 s, a one-layer probe takes about 1.4 s. The cost probes run the
reference's full-window chunks (one q and one kv chunk over the whole
sequence, so a causal prefill counts its whole square); the temp-bytes
probes run the cell's own run config, whose chunks set the live scores.

Usage (one cell, or every cell, per process):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh single [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

The fake default group is process-wide: run the dry run in a process of
its own (tests start it as a subprocess).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _probe_variants(cfg):
    """Probe configs for exact cost extrapolation: a rank's cost is affine
    in the layer count, cost(L) = fixed + L * per_layer, for every
    homogeneous stack. Returns (variants, solver) where variants is a list
    of (tag, cfg) and solver maps {tag: cost} -> extrapolated cost. Whisper
    has two stacks -> three probes."""
    if cfg.family == "audio":
        e = cfg.enc_dec
        v = [("p11", dataclasses.replace(
                 cfg, n_layers=1,
                 enc_dec=dataclasses.replace(e, n_encoder_layers=1))),
             ("p21", dataclasses.replace(
                 cfg, n_layers=1,
                 enc_dec=dataclasses.replace(e, n_encoder_layers=2))),
             ("p12", dataclasses.replace(
                 cfg, n_layers=2,
                 enc_dec=dataclasses.replace(e, n_encoder_layers=1)))]

        def solve(c):
            f_enc = c["p21"] - c["p11"]
            f_dec = c["p12"] - c["p11"]
            fixed = c["p11"] - f_enc - f_dec
            return fixed + e.n_encoder_layers * f_enc + cfg.n_layers * f_dec
        return v, solve
    if cfg.family == "hybrid":
        k = cfg.ssm.attn_every
        v = [("p1", dataclasses.replace(cfg, n_layers=k)),
             ("p2", dataclasses.replace(cfg, n_layers=2 * k))]
        n_blocks = cfg.n_layers // k
    else:
        v = [("p1", dataclasses.replace(cfg, n_layers=1)),
             ("p2", dataclasses.replace(cfg, n_layers=2))]
        n_blocks = cfg.n_layers

    def solve(c):
        body = c["p2"] - c["p1"]
        fixed = c["p1"] - body
        return fixed + n_blocks * body
    return v, solve


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Traffic(TorchDispatchMode):
    """Counts, while active, the bytes each computing op reads and writes
    (``bytes``: its tensor operands and results, once each; views, aliases
    and allocations count 0; collectives are left to the collective log)
    and the peak of live bytes of the storages made inside (``peak``)."""

    _FREE = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._tracked = set()

    def _free(self, key, n):
        self._tracked.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("c10d", "_c10d_functional"):
            return out
        ins = [t for t in tree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        seen = {_storage(t) for t in ins}
        fresh = [t for t in outs if _storage(t) not in seen]
        name = func._schema.name.split("::")[-1]
        if (fresh or func._schema.is_mutable) and name not in self._FREE:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in fresh:
            key = _storage(t)
            if key in self._tracked:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self._tracked.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def prepare(arch, shape_name, mesh, run_cfg, cfg_override=None):
    """Build this rank's step (``shape_name`` one of ``SHAPES`` or a
    ``ShapeSpec``) on meta tensors; returns (call, arg_bytes,
    aliased_bytes): ``call()`` runs the step once and returns its output,
    ``arg_bytes`` are the step's local arguments (parameters, optimizer
    state, inputs, cache), ``aliased_bytes`` those it updates in place."""
    from repro_torch.launch.steps import build_step
    from repro_torch.train.train_step import local_batch

    fn, args, meta = build_step(arch, shape_name, mesh, run_cfg=run_cfg,
                                cfg_override=cfg_override, device="meta")
    model, kind = meta["model"], meta["kind"]
    params = _tree_bytes(list(model.parameters()))
    batch = args[-2] if kind == "train" else args[-1]
    inputs = _tree_bytes(local_batch(model, batch, mesh, kind))
    if kind == "train":
        opt = meta["init_opt"]()
        state = params + _tree_bytes(opt)
        return (lambda: fn(opt, batch, None)), state + inputs, state
    if kind == "prefill":
        return (lambda: fn(batch)), params + inputs, 0
    cache = model.init_cache(meta["shape_spec"])
    nc = _tree_bytes(cache)
    return (lambda: fn(cache, batch)), params + inputs + nc, nc


def counted(call) -> dict:
    """FLOPs, bytes and collectives of one run of ``call``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.collectives import record_collectives, summarize
    with record_collectives() as records, \
            FlopCounterMode(display=False) as flops, Traffic() as traffic:
        call()
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(traffic.bytes),
            "collectives": summarize(records)}


def _peak(call) -> tuple:
    """Peak live bytes of one run of ``call``, and the bytes of the
    tensors it returns that it made (not those it updated in place)."""
    with Traffic() as traffic:
        out = call()
    return traffic.peak, sum(
        _nbytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)
        and _storage(t) in traffic._tracked)


def probe_run_config(mesh, shape, **overrides):
    """The cost probes' run config: the plain forms and the reference's
    full-window chunks (one q and one kv chunk over the sequence, chunks of
    512 for the recurrences)."""
    from repro_torch.launch.steps import default_run_config
    seq_full = max(shape.seq_len if shape.kind != "decode" else 1, 1)
    return default_run_config(mesh, shape, **dict(
        overrides, attn_impl="plain", layer_mode="unroll",
        q_chunk=max(seq_full, 128), kv_chunk=max(seq_full, 128),
        seq_chunk=512))


def _parse_overrides(txt: str) -> dict:
    out = {}
    for kv in filter(None, txt.split(",")):
        k, v = kv.split("=")
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        elif v in ("none", "None"):
            v = None
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


_MESHES = {}


def production_mesh(mesh_kind: str):
    """The production mesh over a fake default group of its world (256 or
    512 ranks, this process rank 0), made once per process and kind."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    if mesh_kind not in _MESHES:
        world = 512 if mesh_kind == "multi" else 256
        if dist.is_initialized() and dist.get_world_size() != world:
            _MESHES.clear()
            dist.destroy_process_group()
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
        _MESHES[mesh_kind] = make_production_mesh(
            multi_pod=(mesh_kind == "multi"), device_type="cpu")
    return _MESHES[mesh_kind]


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             run_overrides: dict | None = None, tag: str = "") -> dict:
    from repro_torch.configs import applicable_shapes, get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import default_run_config
    from repro_torch.models.sharding import use_mesh

    cfg = get_config(arch)
    os.makedirs(out_dir, exist_ok=True)
    if shape_name not in applicable_shapes(cfg):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped",
               "reason": "full-attention arch: long_500k inapplicable "
                         "(DESIGN.md §Arch-applicability)"}
        with open(os.path.join(out_dir,
                               f"{arch}_{shape_name}_{mesh_kind}.json"),
                  "w") as fh:
            json.dump(rec, fh, indent=1)
        return rec

    shape = SHAPES[shape_name]
    t0 = time.time()
    run_overrides = dict(run_overrides or {})
    if "data_axes" in run_overrides and isinstance(run_overrides["data_axes"], str):
        run_overrides["data_axes"] = tuple(run_overrides["data_axes"].split("+"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "overrides": {k: str(v) for k, v in run_overrides.items()},
           "tag": tag, "dtype": cfg.dtype}
    try:
        mesh = production_mesh(mesh_kind)
        rec["n_devices"] = mesh.device_mesh.size()
        with use_mesh(mesh):
            base_rc = default_run_config(
                mesh, shape, **dict(run_overrides, attn_impl="plain"))
            probe_rc = probe_run_config(mesh, shape, **run_overrides)
            # the full-depth step: its arguments, the cell's proof of layout
            _, arg_bytes, alias_bytes = prepare(arch, shape_name, mesh,
                                                 base_rc)
            variants, solve = _probe_variants(cfg)
            costs, temps, outs = {}, {}, {}
            for ptag, pcfg in variants:
                costs[ptag] = counted(prepare(arch, shape_name, mesh,
                                                probe_rc, pcfg)[0])
                temps[ptag], outs[ptag] = _peak(prepare(
                    arch, shape_name, mesh, base_rc, pcfg)[0])
        rec["trace_s"] = round(time.time() - t0, 2)

        def solve_field(get):
            return solve({t: get(costs[t]) for t in costs})

        kinds = set()
        for c in costs.values():
            kinds |= set(c["collectives"])
        rec["cost"] = {
            "flops": solve_field(lambda c: c["flops"]),
            "bytes_accessed": solve_field(lambda c: c["bytes_accessed"]),
            "collectives": {
                k: {"bytes": solve_field(
                        lambda c: c["collectives"].get(k, {}).get("bytes", 0)),
                    "count": solve_field(
                        lambda c: c["collectives"].get(k, {}).get("count", 0)),
                    "group": max((c["collectives"].get(k, {}).get("group")
                                  or 0) for c in costs.values())}
                for k in kinds},
            "method": "probe-extrapolated on meta tensors, rank 0 (exact "
                      "for homogeneous stacks): FlopCounterMode FLOPs, "
                      "unfused operand+result bytes, the collective log",
        }
        # the step's outputs alias what it updates in place (parameters and
        # optimizer state, the cache); a returned tensor is new
        out_bytes = solve(outs)
        rec["memory"] = {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes + alias_bytes,
            "temp_bytes": max(0, solve(temps)),
            "alias_bytes": alias_bytes,
            "method": "arguments exact from the local shapes; temp the "
                      "peak live bytes of the storages the step makes, at "
                      "the cell's run config, probe-extrapolated",
        }
        rec["status"] = "ok"
        rec["run_cfg"] = {"layer_mode": base_rc.layer_mode,
                          "q_chunk": base_rc.q_chunk,
                          "kv_chunk": base_rc.kv_chunk,
                          "seq_chunk": base_rc.seq_chunk,
                          "capacity_factor": base_rc.moe_capacity_factor,
                          "attn_impl": base_rc.attn_impl}
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(trace {rec['trace_s']}s, "
              f"flops/dev {rec['cost']['flops']:.3e}, "
              f"temp {rec['memory']['temp_bytes'] / 2**30:.2f} GiB)")
        print(f"  collectives: {rec['cost']['collectives']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAIL {rec['error']}")

    suffix = f"_{tag}" if tag else ""
    fname = f"{arch}_{shape_name}_{mesh_kind}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--override", type=str, default="",
                    help="RunConfig overrides, e.g. sharded_decode=true")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import (all_arch_names, applicable_shapes,
                                     get_config)

    if args.all:
        cells = [(arch, shape) for arch in all_arch_names()
                 for shape in applicable_shapes(get_config(arch))]
    else:
        cells = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        for arch, shape in cells:
            fname = os.path.join(args.out, f"{arch}_{shape}_{mesh_kind}.json")
            if args.skip_existing and os.path.exists(fname):
                with open(fname) as fh:
                    if json.load(fh).get("status") in ("ok", "skipped"):
                        print(f"[dryrun] skip existing {fname}")
                        continue
            run_cell(arch, shape, mesh_kind, args.out,
                     run_overrides=_parse_overrides(args.override),
                     tag=args.tag)


if __name__ == "__main__":
    main()
