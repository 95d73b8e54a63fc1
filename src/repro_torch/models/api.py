"""Model factory + run configuration.

``build_model(cfg, run_cfg, device)`` returns an ``nn.Module`` with the
surface the serving and training layers use:

    init_params(generator)  -> fills the parameters in place from a seed
    forward(batch)          -> logits (prefill forward)
    decode_step(cache, batch) -> (logits, cache)
    init_cache(shape)       -> zeroed KV cache for decode shapes
    loss_fn(batch)          -> mean next-token cross-entropy (training)

Every family is ported: dense, moe and vlm (``DecoderLM``), ssm
(``RWKV6Model``), hybrid (``Zamba2Model``) and audio (``WhisperModel``,
which adds ``prefill_cross(frames, cache)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.compat import DeviceLike
from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs (orthogonal to the architecture). Same fields as the
    reference so one (ArchConfig, RunConfig) pair keys both packages; the
    fields that steer scan/remat/sharding are carried but not read yet.
    One default differs: ``seq_chunk``."""

    attn_impl: str = "kernel"     # kernel | plain | reference
    q_chunk: int = 512
    kv_chunk: int = 1024
    layer_mode: str = "scan"
    attn_unroll: bool = False
    remat: bool = True
    remat_policy: str = "full"
    sharded_decode: bool = False
    fsdp_experts: bool = False
    moe_capacity_factor: float = 1.25
    # the recurrences' chunk: 64 (the reference's default is 256) keeps
    # |log w| * chunk within fp32's exp range and the kernels' limit
    seq_chunk: int = 64
    data_axes: tuple = ("pod", "data")
    model_axis: str = "model"
    use_zero1: bool = False
    grad_compress: bool = False
    grad_accum: int = 1


def build_model(cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                device: DeviceLike = None):
    run_cfg = run_cfg or RunConfig()
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, run_cfg, device=device)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import RWKV6Model
        return RWKV6Model(cfg, run_cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.ssm import Zamba2Model
        return Zamba2Model(cfg, run_cfg, device=device)
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg, run_cfg, device=device)
    raise ValueError(f"unknown family {cfg.family}")
