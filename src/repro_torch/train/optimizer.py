"""AdamW written out by hand over dicts of tensors.

Counterpart of ``repro.train.optimizer`` (``adamw_init``, ``adamw_update``),
step for step: a global-norm clip of the gradients, fp32 moments, bias
correction, decoupled weight decay on the parameter, the update computed in
fp32 and cast back to the parameter's dtype. Not ``torch.optim``: the
arithmetic is the reference's, so one step on converted weights matches it.

Trees are dicts keyed by ``state_dict`` names (``"layers.wq"``), the
reference's nested keys joined by dots. One difference that comes with
PyTorch's idiom: ``adamw_update`` writes the new parameters and moments
into the tensors it is given (under ``torch.no_grad()``) where the
reference returns new arrays; it returns them all the same. The ZeRO-1
partition specs (``zero1_pspec``, ``adamw_pspecs``, ``adamw_init_specs``)
belong to the sharded path, which is not ported (ROADMAP A13).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    mu: Tree                # first moments, fp32
    nu: Tree                # second moments, fp32


def adamw_init(params: Tree) -> AdamWState:
    """Zero fp32 moments shaped like ``params`` and step 0."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0
                 ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step. Returns ``(params, state, grad_norm)``; ``params``
    and the state's moments are the tensors passed in, updated in place.
    ``grad_norm`` is the fp32 global norm before clipping (0 with no
    clip), a 0-d tensor: reading it is left to the caller."""
    step = state.step + 1
    dev = step.device
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())).to(dev)
                               for g in grads.values()))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        scale = torch.ones((), dtype=torch.float32, device=dev)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), stepf)
    for k, p in params.items():
        g = grads[k].float() * scale.to(p.device)
        m, v = state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mh = m / bc1.to(p.device)
        vh = v / bc2.to(p.device)
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
