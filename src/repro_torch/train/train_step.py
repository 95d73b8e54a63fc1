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
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.train.compress import roundtrip_tree
from repro_torch.train.optimizer import AdamWState, adamw_update


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


def make_train_step(model, lr: float = 3e-4,
                    weight_decay: float = 0.1) -> Callable:
    """Returns ``train_step(opt_state, batch, generator) -> (opt_state,
    metrics)``. Honors ``RunConfig.grad_accum`` (``loss_and_grads``) and
    ``RunConfig.grad_compress`` (the gradients through the int8 codec, its
    noise from ``generator``). ``metrics`` holds 0-d tensors: ``loss``,
    ``grad_norm``, ``step``."""
    run = model.run
    params = trainable(model)

    def train_step(opt_state: AdamWState, batch, generator):
        loss, grads = loss_and_grads(model, batch, run.grad_accum)
        if run.grad_compress:
            grads = roundtrip_tree(grads, generator)
        _, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay)
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(batch):
        with torch.no_grad():
            return model.loss_fn(batch)
    return eval_step
