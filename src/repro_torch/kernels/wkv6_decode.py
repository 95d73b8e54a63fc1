"""One decode step of the RWKV6 (WKV) recurrence, in place in the cache.

The step ``RWKV6Model.decode_step`` takes for each layer (prompts go
through K3, ``rwkv6_chunk.py``). No TPU kernel to replace: the reference
decodes in ``jnp`` (``repro.kernels.chunked.wkv6_decode``). Three things
live here, as for every kernel of the port:

  * ``wkv6_decode_plain`` — the plain PyTorch version: the rows whose
    ``cache_len`` is 0 zeroed (``keep``), ``chunked.wkv6_decode``, the new
    state copied back into the cache. The CPU tests reach it, and
    ``chip_smoke.py`` holds the kernel against it;
  * ``wkv6_decode`` — the wrapper: on a CUDA tensor it launches the
    hand-written kernel ``csrc/wkv6_decode.cu``, which reads and writes each
    state element once, or raises (there is no fall-back); on a CPU tensor
    it takes the plain version;
  * ``wkv6_decode.launches`` — one more per kernel launch.

Shapes: r, k, w (B, 1, H, dk); v (B, 1, H, dv); u (H, dk); state
(B, H, dk, dv), the layer's slice of the cache; cache_len a scalar or
(B,). The kernel takes r, k, v in float32 or bfloat16 (one dtype) and w, u
and the state in float32, each contiguous, the state 16-byte aligned, dk
at most 128 and dv a multiple of 4 up to 128. Both forms write the new
state into ``state`` and return y (B, 1, H, dv) float32; a row at length 0
starts from zero state, whatever its slice of the cache held.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunked import wkv6_decode as wkv6_decode_step
from repro_torch.kernels.decode_attention import _lens_tensor

MAX_D = 128


def kept(state, cache_len):
    """``state`` times each row's keep: 1 for a row that continues, 0 for
    one that starts (multiplied in, so no branch depends on the
    lengths)."""
    keep = (torch.as_tensor(cache_len, device=state.device) > 0).to(
        torch.float32).reshape(-1).expand(state.shape[0])
    return state * keep[:, None, None, None]


def wkv6_decode_plain(r, k, v, w, u, state, cache_len):
    """``chunked.wkv6_decode`` on the ``kept`` state, the new state copied
    into ``state``."""
    y, new_state = wkv6_decode_step(r, k, v, w, u, kept(state, cache_len))
    state.copy_(new_state)
    return y


def _check(r, k, v, w, u, state) -> None:
    if r.ndim != 4 or r.shape[1] != 1 or k.shape != r.shape \
            or w.shape != r.shape or v.ndim != 4 \
            or v.shape[:3] != r.shape[:3]:
        raise ValueError("r, k, w must be (B,1,H,dk) and v (B,1,H,dv): "
                         f"{tuple(r.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} {tuple(w.shape)}")
    b, _, h, dk = r.shape
    dv = v.shape[-1]
    if u.shape != (h, dk):
        raise ValueError(f"u must be ({h}, {dk}), got {tuple(u.shape)}")
    if state.shape != (b, h, dk, dv):
        raise ValueError(f"state must be ({b}, {h}, {dk}, {dv}), got "
                         f"{tuple(state.shape)}")
    if not 1 <= dk <= MAX_D or not 4 <= dv <= MAX_D or dv % 4:
        raise ValueError(f"dk {dk} / dv {dv} not taken: dk in [1, {MAX_D}], "
                         f"dv a multiple of 4 in [4, {MAX_D}]")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {r.dtype} not taken (float32 or bfloat16)")
    for name, t, dt in (("k", k, r.dtype), ("v", v, r.dtype),
                        ("w", w, torch.float32), ("u", u, torch.float32),
                        ("state", state, torch.float32)):
        if t.dtype != dt or t.device != r.device:
            raise TypeError(f"{name}: dtype {t.dtype} / device {t.device}, "
                            f"want {dt} on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.data_ptr() % 16:
        raise ValueError("state must be 16-byte aligned")


def wkv6_decode(r, k, v, w, u, state, cache_len):
    """Kernel on CUDA tensors, plain version on CPU tensors; ``state`` is
    written in place, y returned."""
    build.refuse_grad("wkv6_decode", r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_decode_plain(r, k, v, w, u, state, cache_len)
    if r.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {r.device}")
    _check(r, k, v, w, u, state)
    b, _, h, dk = r.shape
    dv = v.shape[-1]
    lens = _lens_tensor(cache_len, b, r.device)
    y = torch.empty((b, 1, h, dv), dtype=torch.float32, device=r.device)
    lib = build.load()
    with build.on_device(r.device):
        code = lib.repro_wkv6_decode(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), lens.data_ptr(), y.data_ptr(),
            b, h, dk, dv, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)
    build.check_launch(lib, code, "wkv6_decode")
    wkv6_decode.launches += 1
    return y


wkv6_decode.launches = 0
