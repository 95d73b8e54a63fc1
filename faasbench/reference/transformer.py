"""Plain float32 reference of a Llama-style decoder (SmolLM).

The architecture as published: token embedding, per layer RMSNorm,
grouped-query attention with split-half rotary embeddings, RMSNorm and a
SiLU-gated MLP, each added to the residual stream, a final RMSNorm and the
tied embedding as output head. Plain ``torch`` operations, no cache
tricks, no kernels; it imports nothing of the system it checks.

``draw_weights`` derives the weights a served replica holds from its seed:
a frozen copy of the drawing rule of the served program
(``repro_torch.models.transformer.DecoderLM.init_params`` with
``models.layers.dense_init``, as of the benchmark's first version), so the
reference never reads a weight from the program. Departures from the
published model that the served program makes, and this reference
therefore makes too: RMSNorm's epsilon is the config's ``rms_norm_eps``
and the matrices are drawn at N(0, 1/sqrt(n_layers)) (the stacked fan-in).

``precision="fp8"`` rounds every matrix product's two inputs to float8
e4m3 (one scale per weight matrix, one per activation row): the control
that the benchmark's comparison must reject. ``precision="bf16"`` rounds
them to bfloat16: a witness of what the served precision's rounding alone
does to the picks.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

FAMILY = "dense"


def arch_kwargs(spec: dict) -> dict:
    """The served program's architecture fields for this configuration."""
    return dict(name=spec["name"], family=FAMILY,
                n_layers=spec["num_hidden_layers"],
                d_model=spec["hidden_size"],
                n_heads=spec["num_attention_heads"],
                n_kv_heads=spec["num_key_value_heads"],
                d_ff=spec["intermediate_size"], vocab=spec["vocab_size"],
                head_dim=spec["head_dim"],
                tie_embeddings=spec["tie_word_embeddings"],
                rope_theta=spec["rope_theta"], dtype=spec["torch_dtype"])


def _dims(spec: dict):
    return (spec["num_hidden_layers"], spec["hidden_size"],
            spec["num_attention_heads"], spec["num_key_value_heads"],
            spec["head_dim"], spec["intermediate_size"], spec["vocab_size"])


def weight_shapes(spec: dict):
    """(name, shape, scale) of every drawn matrix, in the order they are
    drawn; ``None`` scale means 1/sqrt(shape[0])."""
    n_l, d, hq, hkv, hd, f, v = _dims(spec)
    layers = {"wq": (n_l, d, hq * hd), "wk": (n_l, d, hkv * hd),
              "wv": (n_l, d, hkv * hd), "wo": (n_l, hq * hd, d),
              "w_gate": (n_l, d, f), "w_up": (n_l, d, f),
              "w_down": (n_l, f, d)}
    # the program keeps its layer tensors in an ``nn.ParameterDict``,
    # which orders its keys, and draws them in that order
    out = [(k, layers[k], None) for k in sorted(layers)]
    out.append(("embed", (v, d), 0.02))
    if not spec["tie_word_embeddings"]:
        out.append(("lm_head", (d, v), None))
    return out


@torch.no_grad()
def draw_weights(spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The replica's matrices in the dtype it serves them in, drawn as the
    program draws them: one ``torch.Generator`` on ``device`` seeded with
    ``seed``, a float32 normal draw of each whole stacked tensor in turn,
    scaled, then cast. Norm weights are 1 and are not drawn."""
    from_dtype = getattr(torch, spec["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shape, scale in weight_shapes(spec):
        s = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        out[name] = (x * s).to(from_dtype)
    return out


# -- arithmetic -----------------------------------------------------------------

def bf16(x: torch.Tensor, rowwise: bool = False) -> torch.Tensor:
    """``x`` rounded to bfloat16, returned in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def fp8(x: torch.Tensor, rowwise: bool) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under an absmax scale (per row, or one
    for the tensor), returned in float32."""
    amax = x.abs().amax(dim=-1, keepdim=True) if rowwise else x.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Matmul:
    """``a @ w`` in float32, or with both inputs rounded to fp8 (the
    control) or to bf16 (a witness of what bf16 rounding alone does)."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}")
        self.round = {"fp32": None, "fp8": fp8, "bf16": bf16}[precision]

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        return self.round(w, rowwise=False) if self.round else w

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a, rowwise=True) if self.round else a,
                            w)


def rms_norm(x, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def rope(x, pos, theta):
    """Split-half rotation of x (..., S, H, D) at positions pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]         # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(spec, w, i, mm, x, pos, past=None):
    """One decoder layer over x (S, d) at positions pos. ``past`` (K, V)
    of earlier positions, or None; returns (x, (K, V))."""
    _, d, hq, hkv, hd, _, _ = _dims(spec)
    eps, theta = spec["rms_norm_eps"], spec["rope_theta"]
    s = x.shape[0]
    h = rms_norm(x, eps)
    q = rope(mm(h, mm.weight(w["wq"][i])).reshape(s, hq, hd), pos, theta)
    k = rope(mm(h, mm.weight(w["wk"][i])).reshape(s, hkv, hd), pos, theta)
    v = mm(h, mm.weight(w["wv"][i])).reshape(s, hkv, hd)
    if past is not None:
        k, v = torch.cat([past[0], k]), torch.cat([past[1], v])
    g = hq // hkv
    kk, vv = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, kk) / math.sqrt(hd)
    n_past = kk.shape[0] - s
    qi = torch.arange(s, device=x.device)[:, None] + n_past
    ki = torch.arange(kk.shape[0], device=x.device)[None, :]
    scores = scores.masked_fill((ki > qi)[None], float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), vv)
    x = x + mm(o.reshape(s, hq * hd), mm.weight(w["wo"][i]))
    h = rms_norm(x, eps)
    up = F.silu(mm(h, mm.weight(w["w_gate"][i]))) * mm(
        h, mm.weight(w["w_up"][i]))
    return x + mm(up, mm.weight(w["w_down"][i])), (k, v)


def _head(spec, w, mm, x):
    x = rms_norm(x, spec["rms_norm_eps"])
    head = w["embed"].T if spec["tie_word_embeddings"] else w["lm_head"]
    return mm(x, mm.weight(head))


def _embed(w, mm, tokens):
    return mm.weight(w["embed"])[tokens]


@torch.no_grad()
def forward(spec: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """Logits (S, V) float32 of one sequence ``tokens`` (S,), every
    position attending causally to those before it."""
    mm = Matmul(precision)
    x = _embed(w, mm, tokens.long())
    pos = torch.arange(tokens.shape[0], device=x.device)
    for i in range(spec["num_hidden_layers"]):
        x, _ = _layer(spec, w, i, mm, x, pos)
    return _head(spec, w, mm, x)


@torch.no_grad()
def decode(spec: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The same logits one token at a time, each layer keeping the K and V
    of earlier positions."""
    mm = Matmul(precision)
    past = [None] * spec["num_hidden_layers"]
    rows = []
    for t, tok in enumerate(tokens.long().tolist()):
        x = _embed(w, mm, torch.tensor([tok], device=tokens.device))
        pos = torch.tensor([t], device=tokens.device)
        for i in range(spec["num_hidden_layers"]):
            x, past[i] = _layer(spec, w, i, mm, x, pos, past[i])
        rows.append(_head(spec, w, mm, x))
    return torch.cat(rows)


def logits(spec: dict, w: Dict[str, torch.Tensor], seqs, precision="fp32"):
    """Logits of each sequence in ``seqs`` (a list of (S,) tensors)."""
    return [forward(spec, w, s, precision) for s in seqs]
