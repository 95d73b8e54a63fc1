"""Plain float32 reference of RWKV-6 (Finch), as the served program states it.

Per layer: LayerNorm, the time-mix block (token shift with static mixes
``mu``, receptance, key, value and gate projections, the data-dependent
decay from a rank-64 LoRA, the WKV recurrence with its bonus ``u``, a
normalisation of the heads' outputs, the gated output projection), then
LayerNorm and the channel-mix block (token shift, squared-ReLU key,
sigmoid receptance); an input LayerNorm after the embedding and a final
one before the untied head. Plain ``torch`` operations; it imports nothing
of the system it checks.

Departures from the published Finch block that the served program makes,
and this reference therefore makes too: the token shift mixes with static
``mu`` (no data-dependent LoRA on the mix), the per-token log-decay is
clamped to [-0.5, -1e-4], and the heads' outputs are normalised by one
LayerNorm over all channels instead of a GroupNorm per head.

``draw_weights`` is a frozen copy of the served program's drawing rule
(``repro_torch.models.rwkv.RWKV6Model.init_params`` with
``models.layers.dense_init``, as of the benchmark's first version).
``precision`` ``"fp8"`` (the control) or ``"bf16"`` (a witness) rounds
every matrix product's inputs, as in ``reference/transformer.py``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .transformer import Matmul

FAMILY = "ssm"
LORA_R = 64
LOGW_MIN, LOGW_MAX = -0.5, -1e-4
LN_EPS = 1e-5


def arch_kwargs(spec: dict) -> dict:
    d = spec["hidden_size"]
    return dict(name=spec["name"], family=FAMILY,
                n_layers=spec["num_hidden_layers"], d_model=d,
                n_heads=d // spec["head_size"],
                n_kv_heads=d // spec["head_size"],
                d_ff=spec["intermediate_size"], vocab=spec["vocab_size"],
                head_dim=spec["head_size"], attention_free=True,
                sub_quadratic=True, norm="layernorm", mlp="rwkv",
                dtype=spec["torch_dtype"])


def _dims(spec):
    d, hd = spec["hidden_size"], spec["head_size"]
    return (spec["num_hidden_layers"], d, d // hd, hd,
            spec["intermediate_size"], spec["vocab_size"])


def weight_shapes(spec: dict):
    """(name, shape, scale) of every drawn tensor, in the order drawn."""
    n_l, d, h, hd, f, v = _dims(spec)
    layers = {n: ((n_l, d, d), None) for n in ("w_r", "w_k", "w_v", "w_g",
                                               "w_o", "c_r")}
    layers.update({"decay_A": ((n_l, d, LORA_R), None),
                   "decay_B": ((n_l, LORA_R, d), None),
                   "bonus_u": ((n_l, h, hd), 0.3),
                   "c_k": ((n_l, d, f), None), "c_v": ((n_l, f, d), None)})
    # in the order of the program's ``nn.ParameterDict``, which sorts
    return [(k,) + layers[k] for k in sorted(layers)] + [
        ("embed", (v, d), 0.02), ("lm_head", (d, v), None)]


# the tensors the program keeps in float32 whatever the config's dtype
FP32 = ("bonus_u",)


@torch.no_grad()
def draw_weights(spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """As ``transformer.draw_weights``; constants (norms 1 and 0, every
    ``mu`` 0.5, ``decay_base`` -2) are not drawn."""
    dt = getattr(torch, spec["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shape, scale in weight_shapes(spec):
        s = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        out[name] = (x * s).to(torch.float32 if name in FP32 else dt)
    return out


def layer_norm(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS)


def _mix(x, xs, mu=0.5):
    return x + (xs - x) * mu


class State:
    """Per sequence and layer: the WKV state (B, H, hd, hd) and the last
    normalised inputs of the two blocks (B, d)."""

    def __init__(self, spec, batch, device):
        n_l, d, h, hd, _, _ = _dims(spec)
        z = dict(dtype=torch.float32, device=device)
        self.wkv = [torch.zeros((batch, h, hd, hd), **z) for _ in range(n_l)]
        self.att = [torch.zeros((batch, d), **z) for _ in range(n_l)]
        self.ffn = [torch.zeros((batch, d), **z) for _ in range(n_l)]


def _wkv_scan(r, k, v, w, u, state):
    """The recurrence over time. r, k, v, w: (B, S, H, hd); u (H, hd);
    state (B, H, hd, hd). y_t = r_t (S + u k_t v_t^T); S <- w_t S + k_t v_t^T."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _wkv_parallel(r, k, v, w, u):
    """The same outputs from zero state, all positions at once:
    y_t = sum_{s<t} r_t (prod_{s<j<t} w_j) k_s v_s + r_t u k_t v_t."""
    b, s, h, hd = r.shape
    cum = torch.cumsum(torch.log(w), dim=1)                 # (B, S, H, hd)
    # decay from just after s to just before t: cum[t-1] - cum[s]
    prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    diff = prev[:, :, None] - cum[:, None, :]               # (B, t, s, H, hd)
    lower = torch.tril(torch.ones(s, s, device=r.device), diagonal=-1)
    dec = torch.exp(torch.clamp(diff, max=0.0)) * lower[None, :, :, None, None]
    att = torch.einsum("bthk,btshk,bshk->bhts", r, dec, k)
    y = torch.einsum("bhts,bshv->bthv", att, v)
    bonus = torch.einsum("bthk,hk,bthk->bth", r, u, k)
    return y + bonus[..., None] * v


def _layer(spec, w, i, mm, x, st, parallel):
    """Layer ``i`` over x (B, S, d), continuing from ``st``."""
    _, d, h, hd, _, _ = _dims(spec)
    b, s, _ = x.shape
    hh = layer_norm(x)
    xs = torch.cat([st.att[i][:, None], hh[:, :-1]], dim=1)
    r = mm(_mix(hh, xs), mm.weight(w["w_r"][i])).reshape(b, s, h, hd)
    k = mm(_mix(hh, xs), mm.weight(w["w_k"][i])).reshape(b, s, h, hd)
    v = mm(_mix(hh, xs), mm.weight(w["w_v"][i])).reshape(b, s, h, hd)
    g = F.silu(mm(_mix(hh, xs), mm.weight(w["w_g"][i])))
    lora = torch.tanh(mm(_mix(hh, xs), mm.weight(w["decay_A"][i])))
    logw = -2.0 + mm(lora, mm.weight(w["decay_B"][i]))
    decay = torch.exp(torch.clamp(-torch.exp(logw), LOGW_MIN, LOGW_MAX))
    decay = decay.reshape(b, s, h, hd)
    u = w["bonus_u"][i].float()
    if parallel:
        y = _wkv_parallel(r, k, v, decay, u)
    else:
        y, st.wkv[i] = _wkv_scan(r, k, v, decay, u, st.wkv[i])
    st.att[i] = hh[:, -1]
    y = layer_norm(y.reshape(b, s, d))
    x = x + mm(y * g, mm.weight(w["w_o"][i]))
    hh = layer_norm(x)
    xs = torch.cat([st.ffn[i][:, None], hh[:, :-1]], dim=1)
    kk = torch.relu(mm(_mix(hh, xs), mm.weight(w["c_k"][i]))) ** 2
    rr = torch.sigmoid(mm(_mix(hh, xs), mm.weight(w["c_r"][i])))
    st.ffn[i] = hh[:, -1]
    return x + mm(kk, mm.weight(w["c_v"][i])) * rr


def _run(spec, w, tokens, precision, parallel, st=None):
    mm = Matmul(precision)
    x = layer_norm(mm.weight(w["embed"])[tokens.long()])
    st = st or State(spec, tokens.shape[0], tokens.device)
    for i in range(spec["num_hidden_layers"]):
        x = _layer(spec, w, i, mm, x, st, parallel)
    return mm(layer_norm(x), mm.weight(w["lm_head"])), st


@torch.no_grad()
def forward(spec: dict, w, tokens: torch.Tensor, precision: str = "fp32",
            parallel: bool = False) -> torch.Tensor:
    """Logits (B, S, V) float32 of ``tokens`` (B, S) from zero state, layer
    by layer over every position: the WKV as a scan over time, or with
    ``parallel`` in its closed form (memory quadratic in S: small sizes)."""
    return _run(spec, w, tokens, precision, parallel)[0]


@torch.no_grad()
def decode(spec: dict, w, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The same logits one token at a time through the recurrent state."""
    st, rows = None, []
    for t in range(tokens.shape[1]):
        out, st = _run(spec, w, tokens[:, t:t + 1], precision, False, st)
        rows.append(out)
    return torch.cat(rows, dim=1)


def logits(spec: dict, w, seqs, precision="fp32"):
    """Logits of each sequence in ``seqs`` (a list of (S,) tensors), all
    run as one batch padded on the right (a position sees only earlier
    ones, so the padding changes nothing before it)."""
    n = max(int(s.shape[0]) for s in seqs)
    batch = torch.zeros((len(seqs), n), dtype=torch.long,
                        device=seqs[0].device)
    for j, s in enumerate(seqs):
        batch[j, : s.shape[0]] = s
    out = forward(spec, w, batch, precision)
    return [out[j, : s.shape[0]] for j, s in enumerate(seqs)]
