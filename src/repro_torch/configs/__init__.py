"""Assigned-architecture registry: get_config("<arch-id>")."""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig, EncDecConfig, MoEConfig, SSMConfig, SHAPES, ShapeSpec,
    applicable_shapes,
)

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch.configs import (qwen3_32b, granite_34b, smollm_360m, glm4_9b,  # noqa
                               kimi_k2, arctic_480b, rwkv6_7b, zamba2_2p7b,
                               whisper_small, qwen2_vl_72b)
    return _REGISTRY[name]


def all_arch_names() -> list[str]:
    from repro_torch.configs import (qwen3_32b, granite_34b, smollm_360m, glm4_9b,  # noqa
                               kimi_k2, arctic_480b, rwkv6_7b, zamba2_2p7b,
                               whisper_small, qwen2_vl_72b)
    return sorted(_REGISTRY.keys())


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "EncDecConfig", "SHAPES",
           "ShapeSpec", "applicable_shapes", "get_config", "all_arch_names",
           "register"]
