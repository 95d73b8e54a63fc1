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
reference returns new arrays; it returns them all the same.

ZeRO-1 (``zero1_pspec``, ``adamw_pspecs``, ``adamw_init_specs``: the
reference's partition specs, over ``P`` and trees of shapes, meta tensors
standing for its ``ShapeDtypeStruct``s). On a mesh the moments of a leaf
that ZeRO-1 shards are this rank's slice of the data axes: each data rank
updates its slice of ``mu``, ``nu`` and the parameter, then the parameter
slices are all-gathered over the data axes, so every rank ends the step
with the whole (and the same) parameter. Elementwise arithmetic, so the
result is the unsharded update's, bit for bit. The clip's global norm is
taken over the gradients as the caller hands them (already reduced over
the data axes): a leaf sharded over mesh axes adds its local squares to a
``psum`` over those axes, a replicated leaf counts once, so the norm
equals the single-device one.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import sharding as S
from repro_torch.models.sharding import P

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    mu: Tree                # first moments, fp32
    nu: Tree                # second moments, fp32


def adamw_init(params: Tree, param_pspecs: Optional[Dict[str, P]] = None,
               mu_pspecs: Optional[Dict[str, P]] = None,
               mesh: Optional[S.Mesh] = None) -> AdamWState:
    """Zero fp32 moments shaped like ``params`` and step 0. With
    ``mu_pspecs`` (ZeRO-1, ``adamw_pspecs(...).mu``) on a mesh, a leaf's
    moments are this rank's slice of the data axes."""
    mesh = mesh if mesh is not None else S.get_mesh()
    dev = next(iter(params.values())).device
    zeros = {}
    for k, p in params.items():
        part = _zero1_part(k, param_pspecs, mu_pspecs, mesh)
        shape = p.shape if part is None else S.local_shape(p.shape, part,
                                                           mesh, k)
        zeros[k] = torch.zeros(shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def adamw_init_specs(param_specs: Tree) -> AdamWState:
    """The state's shapes as meta tensors (the reference's
    ``ShapeDtypeStruct`` version, for planning without memory)."""
    f32 = {k: torch.empty(tuple(s.shape), dtype=torch.float32,
                          device="meta") for k, s in param_specs.items()}
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=f32, nu=dict(f32))


def zero1_pspec(param_pspec: P, shape: tuple, dax) -> P:
    """ZeRO-1: additionally shard optimizer state over the data axes on the
    first dimension that is unsharded (moment tensors are only read/written
    by the optimizer, so data-sharding them removes their replication).
    No-op if the param spec already uses any of the data axes (e.g. FSDP
    expert shards) — a mesh axis may appear only once in a spec."""
    dax_set = set(S.entry_axes(dax))
    for entry in param_pspec:
        if dax_set & set(S.entry_axes(entry)):
            return param_pspec
    dims = list(param_pspec) + [None] * (len(shape) - len(param_pspec))
    for i, (entry, size) in enumerate(zip(dims, shape)):
        if entry is None and size >= 64 and size % 2 == 0:
            dims[i] = dax
            return P(*dims)
    return P(*dims)


def adamw_pspecs(param_pspecs: Dict[str, P], param_specs: Tree,
                 use_zero1: bool = False, dax=("pod", "data")) -> AdamWState:
    """The state's partition specs: the parameters' own, or with
    ``use_zero1`` each moment also sharded over ``dax`` (``zero1_pspec``)."""
    if not use_zero1:
        mu = dict(param_pspecs)
    else:
        mu = {k: zero1_pspec(ps, tuple(param_specs[k].shape), dax)
              for k, ps in param_pspecs.items()}
    return AdamWState(step=P(), mu=mu, nu=dict(mu))


def _zero1_part(name, param_pspecs, mu_pspecs, mesh) -> Optional[P]:
    """The part of a leaf's moment spec that its parameter spec lacks (the
    data axes ZeRO-1 added), or None when the moments are laid out as the
    parameter is on this mesh."""
    if mesh is None or mu_pspecs is None:
        return None
    ps = param_pspecs[name] if param_pspecs is not None else P()
    extra = []
    for i, entry in enumerate(mu_pspecs[name]):
        own = ps[i] if i < len(ps) else None
        extra.append(None if entry == own else entry)
    if not any(mesh.live_axes(e) for e in extra):
        return None
    return P(*extra)


def global_sq_norm(grads: Tree, param_pspecs: Optional[Dict[str, P]],
                   mesh: Optional[S.Mesh], device) -> torch.Tensor:
    """Sum of squares of every gradient as of one device: a leaf sharded
    over mesh axes adds its local squares to a ``psum`` over them, a
    replicated leaf counts once. With no mesh (or a leaf on no live axis)
    the leaves are summed in their order, as one device does."""
    parts: Dict[tuple, torch.Tensor] = {}
    for k, g in grads.items():
        spec = param_pspecs.get(k, P()) if param_pspecs is not None else P()
        axes = () if mesh is None else mesh.live_axes(
            tuple(a for e in spec for a in S.entry_axes(e)))
        sq = torch.sum(torch.square(g.float())).to(device)
        parts[axes] = parts[axes] + sq if axes in parts else sq
    return sum(S.psum(v, axes, mesh) for axes, v in parts.items())


_BLOCK = 1 << 24     # elements a block of an update's temporaries holds


def _row_blocks(t: torch.Tensor):
    """Slices of ``t``'s first dimension (the whole of a 0-d tensor) of at
    most ``_BLOCK`` elements each (one row at least)."""
    if t.ndim == 0:
        return [Ellipsis]
    step = max(1, _BLOCK // max(1, t[0].numel()))
    return [slice(i, i + step) for i in range(0, t.shape[0], step)]


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0, *,
                 param_pspecs: Optional[Dict[str, P]] = None,
                 mu_pspecs: Optional[Dict[str, P]] = None,
                 mesh: Optional[S.Mesh] = None
                 ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step. Returns ``(params, state, grad_norm)``; ``params``
    and the state's moments are the tensors passed in, updated in place.
    ``grad_norm`` is the fp32 global norm before clipping (0 with no
    clip), a 0-d tensor: reading it is left to the caller. On a mesh
    (``mesh``, default the active one) ``param_pspecs`` say which leaves
    are sharded (for the norm) and ``mu_pspecs`` how the moments are
    (ZeRO-1, as ``adamw_init`` laid them out)."""
    mesh = mesh if mesh is not None else S.get_mesh()
    step = state.step + 1
    dev = step.device
    if grad_clip is not None:
        gnorm = torch.sqrt(global_sq_norm(grads, param_pspecs, mesh, dev))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        scale = torch.ones((), dtype=torch.float32, device=dev)
    stepf = step.float()
    # the bases are filled on the device: a host value copied there would
    # synchronise, which a captured step (``TrainExecutable``) cannot hold
    bc1 = 1.0 - torch.pow(torch.full((), b1, device=dev), stepf)
    bc2 = 1.0 - torch.pow(torch.full((), b2, device=dev), stepf)
    for k, full in params.items():
        part = _zero1_part(k, param_pspecs, mu_pspecs, mesh)
        sl = None if part is None else S.local_slices(full.shape, part,
                                                      mesh, k)
        p = full if sl is None else full[sl]
        gk = grads[k] if sl is None else grads[k][sl]
        scale_k, bc1_k, bc2_k = (t.to(p.device) for t in (scale, bc1, bc2))
        # elementwise: a leaf is updated a block of rows at a time, so its
        # temporaries stay small (at qwen3-32b's width the embedding's part
        # is 0.78 GB a rank); the result is the whole leaf's, bit for bit
        for rows in _row_blocks(p):
            pb, m, v = p[rows], state.mu[k][rows], state.nu[k][rows]
            g = gk[rows].float() * scale_k
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1_k
            vh = v / bc2_k
            pf = pb.float()
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
            pb.copy_((pf - lr * delta).to(pb.dtype))
        if part is not None:
            # every data rank updated its slice: gather the whole
            full.copy_(S.gather(p, part, mesh))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
