"""Per-layer activation checkpointing: the counterpart of the reference's
``jax.checkpoint`` around a layer when ``RunConfig.remat`` is on.

``layer(run, fn, *args)`` runs ``fn(*args)``, one layer of a stack, under
``torch.utils.checkpoint.checkpoint`` (non-reentrant) when ``run.remat``
is on and gradients are being recorded: the forward keeps the layer's
inputs only, and the backward runs the layer again to get what its
gradient needs. The values, the loss and every gradient are those of the
run without it, bit for bit: the recompute runs the same operations on the
same inputs. A caller passes no cache when it wants one checkpointed (the
reference checkpoints no decode step); under ``torch.no_grad()`` or
``torch.inference_mode()`` nothing is.

Two policies, as the reference's ``RunConfig.remat_policy`` (any value
but ``"dots"`` is ``"full"`` there and here):

  * ``"full"`` saves nothing inside the layer;
  * ``"dots"`` saves the outputs of the products without batch dimensions
    and recomputes the rest, as JAX's
    ``checkpoint_policies.dots_with_no_batch_dims_saveable`` does: the
    ``x @ W`` products, which ``torch.matmul`` runs as ``aten.mm`` /
    ``aten.addmm`` once it folds the leading dimensions. The attention's
    batched products (``bmm``) are recomputed.

No forward draws random numbers (only ``init_params`` does), so no RNG
state is kept (``preserve_rng_state=False``); reading the CUDA generator's
state would not be allowed inside a CUDA graph's capture either. The
recompute enters the forward's mesh and collective log: on CUDA it runs on
autograd's thread, where they are unset, and a collective it runs again is
then logged as the reference's recompute is counted.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import sharding as S

# the products "dots" saves: those with no batch dimensions
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Recompute:
    """The policy's recompute context, entered with the mesh and collective
    log that were active when the forward ran: on CUDA the recompute runs
    on autograd's thread, where neither is set. It may be entered again
    (a second backward)."""

    def __init__(self, inner):
        self.inner, self.mesh, self.log = inner, S.get_mesh(), S.get_log()
        self.stacks = []

    def __enter__(self):
        stack = contextlib.ExitStack()
        for ctx in (self.inner, S.use_mesh(self.mesh),
                    S.log_collectives(self.log)):
            stack.enter_context(ctx)
        self.stacks.append(stack)
        return self

    def __exit__(self, *exc):
        return self.stacks.pop().__exit__(*exc)


def _contexts(policy: str):
    """``checkpoint``'s ``context_fn``: the forward's and the recompute's
    context managers."""
    def make():
        if policy == "dots":
            forward, recompute = create_selective_checkpoint_contexts(_dots)
        else:
            forward, recompute = (contextlib.nullcontext(),
                                  contextlib.nullcontext())
        return forward, _Recompute(recompute)
    return make


def layer(run, fn: Callable, *args, policy: str = "full"):
    """``fn(*args)``, checkpointed when ``run.remat`` is on and gradients
    are recorded. ``fn`` must depend on its arguments and on values that
    stay as they are until the backward (it runs again then): a loop
    passes its per-layer values as arguments, never through a closure over
    the loop variable."""
    if not (run.remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_contexts(policy))
