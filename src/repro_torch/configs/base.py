"""Architecture config schema + the four assigned input-shape classes."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual_ff: int = 0     # arctic: parallel dense MLP branch
    capacity_factor: float = 2.0   # per-EP-shard token budget multiplier


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    attn_every: int = 6            # zamba2: shared attn block cadence


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_seq: int = 1500        # whisper: 30 s of audio at 50 Hz


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    attention_free: bool = False   # rwkv6
    sub_quadratic: bool = False    # supports long_500k decode
    dtype: str = "bfloat16"
    source: str = ""               # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = attn + mlp
        if self.moe:
            e = self.moe
            mult = 3 if self.mlp == "swiglu" else 2
            per_layer = attn + e.n_experts * mult * d * e.d_ff_expert \
                + d * e.n_experts \
                + (mult * d * e.dense_residual_ff if e.dense_residual_ff else 0)
        if self.family == "ssm":      # rwkv6: time-mix + channel-mix
            per_layer = 4 * d * d + 2 * d * self.d_ff_or(f)
        if self.family == "hybrid" and self.ssm:
            d_in = self.ssm.expand * d
            mamba = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm.d_state)
            per_layer = mamba + mlp // self.ssm.attn_every  # amortized shared
        return emb + L * per_layer

    def d_ff_or(self, f: int) -> int:
        return f

    @property
    def n_active_params(self) -> int:
        """Active params per token (= n_params for dense)."""
        if not self.moe:
            return self.n_params
        d, L = self.d_model, self.n_layers
        e = self.moe
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mult = 3 if self.mlp == "swiglu" else 2
        active_mlp = e.top_k * mult * d * e.d_ff_expert \
            + (mult * d * e.dense_residual_ff if e.dense_residual_ff else 0)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_mlp)

    def reduced(self, n_layers: int = 2, d_model: int = 64, n_heads: int = 4,
                n_kv_heads: Optional[int] = None, d_ff: int = 128,
                vocab: int = 512) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kv = n_kv_heads if n_kv_heads is not None else max(
            1, n_heads * self.n_kv_heads // max(self.n_heads, 1))
        kw = dict(n_layers=n_layers, d_model=d_model, n_heads=n_heads,
                  n_kv_heads=kv, d_ff=d_ff, vocab=vocab,
                  head_dim=d_model // n_heads, dtype="float32")
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                                d_ff_expert=d_ff,
                                dense_residual_ff=(d_ff if self.moe.dense_residual_ff
                                                   else 0))
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, attn_every=2)
        if self.enc_dec:
            kw["enc_dec"] = replace(self.enc_dec, n_encoder_layers=2,
                                    encoder_seq=24)
        if self.mrope_sections is not None:
            hd = d_model // n_heads
            hw = max(hd // 8, 1)
            kw["mrope_sections"] = (hd // 2 - 2 * hw, hw, hw)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §5)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
