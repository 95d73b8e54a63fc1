"""Builds step functions per (arch x shape x mesh).

Counterpart of ``repro.launch.steps``. The three step kinds map to the
shape classes:
  * train  -> the full train step (forward, backward, AdamW update);
  * prefill -> last-position logits from a full forward;
  * decode -> one-token ``decode_step`` against a KV/state cache.

The reference's ``jax.jit`` becomes, in eager PyTorch on a mesh of
``torch.distributed`` ranks:

  * ``in_shardings`` / ``out_shardings``: the model is built inside
    ``use_mesh(mesh)``, so it holds this rank's shards of
    ``param_pspecs()``; a step takes the global batch and keeps this rank's
    rows of ``input_pspecs`` (the data axes), and a cache is this rank's
    part of ``cache_pspecs`` (``model.init_cache``). Outputs are this
    rank's rows;
  * ``donate_argnums``: the train step updates the parameters and the
    optimizer state in place, the decode step the cache;
  * ``ShapeDtypeStruct``: ``torch.empty(..., device="meta")`` at the
    **global** shapes (``example_args``), storage-free, for planning.

The parameters live in the model (``meta["model"]``), so a step function
takes the reference's arguments after ``params``: ``train(opt_state,
batch, generator) -> (opt_state, metrics)`` (``meta["init_opt"]()`` makes
the optimizer state laid out by the model's specs), ``prefill(batch) ->
logits (B_local, V)`` and ``decode(cache, batch) -> (logits, cache)``.
``example_args`` keep the reference's order, the parameters first. With
the mesh given, everything here runs on ``mesh.device_type``, or on
``device`` where the caller names one: ``"meta"`` for the dry run, whose
step computes shapes and no values (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compat import torch_dtype
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig, build_model
from repro_torch.train.optimizer import adamw_init, adamw_init_specs
from repro_torch.train.train_step import (local_batch, make_train_step,
                                          optimizer_pspecs, trainable)


def default_run_config(mesh, shape: ShapeSpec, **overrides) -> RunConfig:
    """The data axes are ``("pod", "data")`` that the mesh has. ``shape``
    is not read: it keeps the reference's signature."""
    dax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    kw = dict(data_axes=dax)
    kw.update(overrides)
    return RunConfig(**kw)


def meta_tensors(shapes: dict) -> dict:
    """Storage-free tensors at global shapes (name -> (dims, dtype))."""
    return {k: torch.empty(d, dtype=dt, device="meta")
            for k, (d, dt) in shapes.items()}


def input_specs(model, shape: ShapeSpec) -> dict:
    """The step's inputs at the global shape, as meta tensors (the
    reference's ``model.input_specs``)."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len

    def t(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": t(b, 1), "cache_len": t()}
    out = {}
    if cfg.family == "audio":
        out["frames"] = t(b, cfg.enc_dec.encoder_seq, cfg.d_model,
                          dtype=torch_dtype(cfg.dtype))
    out["tokens"] = t(b, s)
    if shape.kind == "train":
        out["labels"] = t(b, s)
    return out


def build_step(arch: str, shape_name: str, mesh,
               run_cfg: Optional[RunConfig] = None, lr: float = 3e-4,
               cfg_override: Optional[ArchConfig] = None,
               device: Optional[str] = None):
    """Returns ``(fn, example_args, meta)``: ``fn`` the step on this rank,
    ``example_args`` meta tensors at the global shapes (the parameters
    first), ``meta`` the names and the model. ``shape_name`` names one of
    ``SHAPES`` or is a ``ShapeSpec`` of its own. The model's parameters are
    allocated (this rank's shards, on ``device``, default the mesh's) and
    uninitialised: fill them with ``meta["model"].init_params`` or
    ``convert.load_params``."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    run_cfg = run_cfg or default_run_config(mesh, shape)
    with S.use_mesh(mesh):
        model = build_model(cfg, run_cfg, device=device or mesh.device_type)
    p_specs = meta_tensors(model.param_shapes())
    in_specs = input_specs(model, shape)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "run_cfg": run_cfg, "model": model, "shape_spec": shape}

    if shape.kind == "train":
        opt_specs = adamw_init_specs(p_specs)
        step = make_train_step(model, lr=lr, mesh=mesh)
        params = trainable(model)

        def init_opt():
            return adamw_init(params, model.param_pspecs(),
                              optimizer_pspecs(model).mu, mesh)

        meta["init_opt"] = init_opt
        rng_spec = torch.empty((2,), dtype=torch.int64, device="meta")
        return step, (p_specs, opt_specs, in_specs, rng_spec), meta

    if shape.kind == "prefill":
        def prefill_step(batch):
            with torch.no_grad():
                logits = model.forward(local_batch(model, batch, mesh,
                                                   "prefill"))
            return logits[:, -1, :]  # serving prefill returns next-token logits

        return prefill_step, (p_specs, in_specs), meta

    # decode
    cache_specs = meta_tensors(model.cache_shapes(shape))

    def decode(cache, batch):
        with torch.no_grad():
            return model.decode_step(cache, local_batch(model, batch, mesh,
                                                        "decode"))

    return decode, (p_specs, cache_specs, in_specs), meta
