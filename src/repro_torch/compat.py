"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. There is no quiet fall-back: an entry point
    asked for the default device on a host without CUDA raises, so a
    measurement can never be taken on the wrong device by accident. Callers
    that want the CPU (the parity tests) say ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` string -> torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def sync(device: torch.device) -> None:
    """Wait for queued device work before a host clock is read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_WARM_STREAMS: dict = {}


def warm_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream a capture's eager warm-up steps run on: one for each
    device, reused. cuBLAS keeps a workspace (32 MiB on Hopper) for every
    stream it has run on, for the life of the process, so a fresh stream
    for each capture would leave one more behind every time a sandbox is
    created (up to the 32 of PyTorch's stream pool)."""
    stream = _WARM_STREAMS.get(device)
    if stream is None:
        stream = _WARM_STREAMS[device] = torch.cuda.Stream(device)
    return stream
