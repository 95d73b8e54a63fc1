"""Train-step factory: loss, gradients (with accumulation), the int8
gradient codec, AdamW.

Counterpart of ``repro.train.train_step``. The model's parameters are its
own ``nn.Parameter``s, keyed by ``named_parameters()`` names; the step
differs from the reference's functional ``(params, opt_state, ...) ->
(params, opt_state, ...)`` in that it **updates the parameters in place**
(``adamw_update`` under ``torch.no_grad()``) and so takes and returns the
optimizer state only. Gradients come from ``torch.autograd.grad`` through
the model's plain forms: the model must run with
``RunConfig(attn_impl="plain")``, since a kernel refuses an input that
requires grad.

The step runs over the mesh (``make_train_step(..., mesh=)``, default the
active one; with none it is one device, where every axis has one rank):
it takes the global batch, keeps this rank's rows of
``model.input_pspecs`` (the data axes), computes the local loss and
gradients (microbatches averaged first under ``grad_accum``), and averages
both over the data axes (``psum / n_data``) before the codec and the
update; with ``RunConfig.use_zero1`` the update is ZeRO-1
(``optimizer.adamw_update``). On one rank each of these is the identity.
On a model axis above one rank the model computes tensor- and
expert-parallel, and its collectives carry their gradients
(``models/sharding.py``): a model-sharded leaf's gradient is this rank's
slice, as its ``param_pspecs`` say, and a replicated leaf's the whole on
every model rank. A leaf sharded over data axes too (FSDP experts) had its
gradient summed over them by the gather's reduce-scatter: it is only
divided.

``TrainExecutable`` is the counterpart of the reference's
``jax.jit(make_train_step(...))``: on CUDA the step captured as a CUDA
graph and replayed (``eager_reason`` says which configurations are
captured, and why the others are not).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.compat import warm_stream
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import sharding as S
from repro_torch.train.compress import roundtrip_tree
from repro_torch.train.optimizer import AdamWState, adamw_pspecs, adamw_update


def trainable(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Turn on gradients for every parameter (they are made without, for
    serving) and return them by name: the tree the optimizer keys on."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def loss_and_grads(model, batch, accum: int = 1):
    """``model.loss_fn`` on ``batch`` and its gradients, by parameter name.
    With ``accum`` > 1 the batch is split along dim 0 into that many equal
    microbatches: their gradients are summed in fp32 and divided by their
    count, their losses averaged (the reference's scan over microbatches).
    The parameters must require grad (``trainable``)."""
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def one(b):
        loss = model.loss_fn(b)
        return loss, torch.autograd.grad(loss, leaves)

    if accum <= 1:
        loss, gs = one(batch)
        return loss.detach(), dict(zip(names, gs))
    micro = [dict(zip(batch, parts)) for parts in zip(
        *(torch.chunk(v, accum, dim=0) for v in batch.values()))]
    if len(micro) != accum or any(v.shape[0] * accum != batch[k].shape[0]
                                  for k, v in micro[0].items()):
        raise ValueError(f"batch does not split into {accum} equal "
                         "microbatches along dim 0")
    sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    losses = []
    for mb in micro:
        loss, gs = one(mb)
        for s, g in zip(sums, gs):
            s.add_(g)
        losses.append(loss.detach())
    return (torch.stack(losses).mean(),
            {n: s / accum for n, s in zip(names, sums)})


def optimizer_pspecs(model) -> AdamWState:
    """The optimizer state's partition specs for ``model``: its parameters'
    own, sharded over the data axes too under ``RunConfig.use_zero1``."""
    run = model.run
    return adamw_pspecs(model.param_pspecs(), dict(model.named_parameters()),
                        use_zero1=run.use_zero1, dax=run.data_axes)


def local_batch(model, batch, mesh, kind: str = "train") -> dict:
    """This rank's rows of a global batch of ``kind`` (``input_pspecs``;
    ``"prefill"`` and ``"decode"`` serve ``launch/steps.py``)."""
    b, s = batch["tokens"].shape
    specs = model.input_pspecs(ShapeSpec(kind, s, b, kind))
    return {k: S.local_shard(torch.as_tensor(v), specs[k], mesh, k)
            for k, v in batch.items()}


def make_train_step(model, lr: float = 3e-4, weight_decay: float = 0.1,
                    mesh: Optional[S.Mesh] = None) -> Callable:
    """Returns ``train_step(opt_state, batch, generator) -> (opt_state,
    metrics)``. Honors ``RunConfig.grad_accum`` (``loss_and_grads``) and
    ``RunConfig.grad_compress`` (the gradients through the int8 codec, its
    noise from ``generator``). ``metrics`` holds 0-d tensors: ``loss``,
    ``grad_norm``, ``step``. The step runs over ``mesh`` (and ZeRO-1 under
    ``use_zero1``): the model must have been built on it, and
    ``opt_state`` must be laid out by
    ``optimizer_pspecs`` (``adamw_init(..., mu_pspecs=...)``; on one rank
    that is ``adamw_init(params)``'s layout)."""
    run = model.run
    params = trainable(model)
    mesh = mesh if mesh is not None else S.get_mesh()
    dax = run.data_axes
    n_data = 1 if mesh is None else mesh.size(dax)
    pspecs = model.param_pspecs()
    mu_pspecs = optimizer_pspecs(model).mu
    live = () if mesh is None else mesh.live_axes(dax)
    # the data axes a leaf's gradient still has to be summed over: all but
    # those its spec shards it on (summed by the backward already)
    sum_over = {k: tuple(a for a in live if a not in
                         {x for e in spec for x in S.entry_axes(e)})
                for k, spec in pspecs.items()}

    def mean(t, axes=dax):
        return S.psum(t, axes, mesh) / n_data if n_data > 1 else t

    def train_step(opt_state: AdamWState, batch, generator):
        loss, grads = loss_and_grads(model, local_batch(model, batch, mesh),
                                     run.grad_accum)
        for k in grads:      # one leaf at a time: the old one is freed
            grads[k] = mean(grads[k], sum_over[k])
        if run.grad_compress:
            grads = roundtrip_tree(grads, generator)
        _, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            param_pspecs=pspecs, mu_pspecs=mu_pspecs, mesh=mesh)
        return opt_state, {"loss": mean(loss), "grad_norm": gnorm,
                           "step": opt_state.step}

    return train_step


# eager steps before a capture, as ``DecodeExecutable``'s: the first pays
# the lazy set-up, the second runs under CUDA's sync debug mode "error", so
# a step that reads the device on the host raises there, naming its op,
# instead of being captured
WARM_STEPS = 2


def eager_reason(cfg, run, mesh: Optional[S.Mesh] = None) -> Optional[str]:
    """Why the train step of ``cfg`` under ``run`` on ``mesh`` is not
    captured as a CUDA graph, or None where it is. A rule fixed before the
    first step, never a reaction to a failed capture: one rank is captured;
    these stay eager:

      * a mesh above one rank: gloo's collectives run on the host;
      * the MoE family: its plain grouped form, which training runs, reads
        the group sizes on the host;
      * ``grad_compress``: the codec seeds each leaf's noise from a host
        integer, a new one every step."""
    ranks = 1 if mesh is None else math.prod(mesh.axis_sizes)
    if ranks > 1:
        return (f"a mesh of {ranks} ranks: gloo's collectives run on the "
                "host")
    if cfg.moe is not None:
        return ("the MoE's plain grouped form reads its group sizes on the "
                "host")
    if run.grad_compress:
        return ("grad_compress: the codec seeds each leaf's noise from a "
                "host integer")
    return None


class TrainExecutable:
    """One train step (``make_train_step``'s ``step_fn``) run on static
    tensors: the batch (a call copies the caller's into it), the AdamW
    state (``opt``: its moments and a ``step`` the step writes in place) and
    the metrics ``loss``, ``grad_norm`` and ``step``, 0-d tensors that the
    next call overwrites (a caller keeps a ``clone``). The model's
    parameters are updated in place by the step itself.

    On a CUDA device the first ``WARM_STEPS`` calls run the step eagerly on
    a side stream (the last under sync debug mode "error"), then one step
    is captured into a graph, which every later call replays: the
    counterpart of the reference's jit, which compiles once and runs the
    program. A failed capture raises, and so does a call of an executable
    whose capture did not happen: it never steps eagerly after its warm
    steps. On the CPU (the tests) every call runs the step eagerly on the
    same tensors. ``batch`` gives the static batch's shapes and dtypes (a
    ``meta`` template will do)."""

    def __init__(self, step_fn: Callable, opt: AdamWState, batch: dict,
                 device, who: str = "model"):
        self.step_fn, self.who = step_fn, who
        self.device = torch.device(device)
        self.batch = {k: torch.zeros(v.shape, dtype=v.dtype,
                                     device=self.device)
                      for k, v in batch.items()}
        self.opt = opt
        self.metrics = {
            "loss": torch.zeros((), dtype=torch.float32, device=self.device),
            "grad_norm": torch.zeros((), dtype=torch.float32,
                                     device=self.device),
            "step": opt.step}
        self.graph = None
        self.warm_steps = self.replays = self.eager_steps = 0
        self.capture_s: Optional[float] = None    # host seconds of capture

    def _step(self) -> None:
        """One step on the static tensors (the body a graph holds)."""
        opt, m = self.step_fn(self.opt, self.batch, None)
        self.opt.step.copy_(opt.step)
        self.metrics["loss"].copy_(m["loss"])
        self.metrics["grad_norm"].copy_(m["grad_norm"])

    def _warm(self) -> None:
        """An eager step on a side stream; the last under sync debug mode
        "error", then the capture."""
        side = warm_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            if self.warm_steps < WARM_STEPS - 1:
                self._step()
            else:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._step()
                except RuntimeError as e:
                    raise RuntimeError(
                        f"{self.who}: the train step reads the device on "
                        f"the host, so it cannot be captured: {e}") from e
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.warm_steps += 1
        if self.warm_steps == WARM_STEPS:
            self._capture()

    def _capture(self) -> None:
        """Record one step into a graph with its own memory pool. A capture
        runs nothing: the next call's replay is the next step."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self._step()
        except Exception as e:
            raise RuntimeError(f"{self.who}: the train step could not be "
                               f"captured as a CUDA graph: {e}") from e
        self.capture_s = time.perf_counter() - t0
        self.graph = graph

    def __call__(self, batch: dict) -> dict:
        """Copy ``batch`` into the static batch and run one step; returns
        the static metrics."""
        for k, t in self.batch.items():
            if tuple(batch[k].shape) != tuple(t.shape):
                raise ValueError(f"{self.who}: batch[{k!r}] has shape "
                                 f"{tuple(batch[k].shape)}, the executable "
                                 f"{tuple(t.shape)}")
            t.copy_(batch[k])
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
        elif self.device.type != "cuda":
            self._step()
            self.eager_steps += 1
        elif self.warm_steps < WARM_STEPS:
            self._warm()
        else:
            raise RuntimeError(f"{self.who}: this train executable on "
                               f"{self.device} was not captured; it never "
                               "steps eagerly after its warm steps")
        return self.metrics


def make_eval_step(model) -> Callable:
    def eval_step(batch):
        with torch.no_grad():
            return model.loss_fn(batch)
    return eval_step
