"""Model factory + run configuration.

``build_model(cfg, run_cfg, device)`` returns an ``nn.Module`` with the
surface the serving layer uses:

    init_params(generator)  -> fills the parameters in place from a seed
    forward(batch)          -> logits (prefill forward)
    decode_step(cache, batch) -> (logits, cache)
    init_cache(shape)       -> zeroed KV cache for decode shapes

Only the dense family is ported so far; the others raise
``NotImplementedError`` naming their ROADMAP item.
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
    fields that steer scan/remat/sharding are carried but not read yet."""

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
    seq_chunk: int = 256
    data_axes: tuple = ("pod", "data")
    model_axis: str = "model"
    use_zero1: bool = False
    grad_compress: bool = False
    grad_accum: int = 1


_PENDING = {
    "moe": "A10 (models/moe.py)",
    "vlm": "A10 (VLM leg, apply_mrope)",
    "ssm": "A8 (models/rwkv.py, kernel K3)",
    "hybrid": "A9 (models/ssm.py, kernel K4)",
    "audio": "A11 (models/whisper.py)",
}


def build_model(cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                device: DeviceLike = None):
    run_cfg = run_cfg or RunConfig()
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, run_cfg, device=device)
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP item {_PENDING[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")
