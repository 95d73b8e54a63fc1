"""Decoder-only transformer LM: the dense, moe and vlm families (serving
paths).

Counterpart of ``repro.models.transformer.DecoderLM``. Differences that come
with PyTorch's idiom:

  * it is an ``nn.Module`` that owns its parameters; they keep the reference
    tree's keys and the stacked leading ``L`` axis (``embed``,
    ``final_norm``, ``layers.{ln1,ln2,wq,wk,wv,wo,...}``, optional
    ``lm_head``), so one converter serves every model;
  * a Python loop over ``L`` stands where the reference scans; there is no
    remat, no sharding constraint and no PartitionSpec;
  * attention goes through ``repro_torch.kernels.ops``: with
    ``RunConfig.attn_impl == "kernel"`` a CUDA tensor reaches the
    hand-written flash-attention (``forward``) and flash-decode
    (``decode_step``) kernels;
  * **the KV cache is updated in place** (``index_put_`` for per-slot
    lengths, ``index_copy_`` for a scalar length) where the reference
    returns a new array; ``decode_step`` still returns ``(logits, cache)``
    and the returned cache is the one passed in;
  * MoE layers (``cfg.moe``) run the single-device ``models/moe.py`` path
    in place of the dense MLP; the vlm family rotates by M-RoPE with the
    text-only position stream ``(pos, pos, pos)``, as the reference does
    (its vision front end is a stub);
  * serving only: no ``loss_fn``, no expert-parallel or sharded decode yet.
    Call it under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.api import RunConfig
from repro_torch.models.moe import init_moe_param, moe_ffn, moe_param_shapes


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``."""
        super().__init__()
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab, cfg.d_model, dtype=torch_dtype(cfg.dtype), device=dev),
            requires_grad=False)
        self.final_norm = nn.Parameter(torch.empty(
            cfg.d_model, dtype=torch.float32, device=dev),
            requires_grad=False)
        self.layers = nn.ParameterDict({
            k: nn.Parameter(torch.empty((cfg.n_layers,) + shape, dtype=dt,
                                        device=dev), requires_grad=False)
            for k, (shape, dt) in self._layer_shapes().items()})
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.vocab, dtype=torch_dtype(cfg.dtype),
                device=dev), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ params
    def _layer_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        f32 = torch.float32
        shapes = {
            "ln1": ((d,), f32),
            "ln2": ((d,), f32),
            "wq": ((d, hq * hd), dt),
            "wk": ((d, hkv * hd), dt),
            "wv": ((d, hkv * hd), dt),
            "wo": ((hq * hd, d), dt),
        }
        if cfg.qk_norm:
            shapes["q_norm"] = ((hd,), f32)
            shapes["k_norm"] = ((hd,), f32)
        if cfg.moe is not None:
            shapes.update(moe_param_shapes(cfg))
        elif cfg.mlp == "swiglu":
            shapes.update({"w_gate": ((d, f), dt), "w_up": ((d, f), dt),
                           "w_down": ((f, d), dt)})
        else:
            shapes.update({"w_up": ((d, f), dt), "b_up": ((f,), f32),
                           "w_down": ((f, d), dt), "b_down": ((d,), f32)})
        return shapes

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DecoderLM":
        """Fill the parameters in place from ``generator`` (which must live
        on the parameters' device). Scales are the reference's: norms 1,
        biases 0, embeddings N(0, 0.02), every other matrix
        N(0, 1/sqrt(fan_in)) with ``fan_in`` read off the stacked shape;
        the MoE keys follow ``moe.init_moe_param`` (their own fan-in, drawn
        a matrix at a time)."""
        moe_keys = moe_param_shapes(self.cfg) if self.cfg.moe else {}
        for k, p in self.layers.items():
            if k in moe_keys:
                init_moe_param(generator, k, p)
            elif k.startswith("ln") or k.endswith("norm"):
                p.fill_(1.0)
            elif k.startswith("b_"):
                p.zero_()
            else:
                p.copy_(L.dense_init(generator, p.shape, p.dtype,
                                     device=p.device))
        self.embed.copy_(L.dense_init(generator, self.embed.shape,
                                      self.embed.dtype, scale=0.02,
                                      device=self.embed.device))
        self.final_norm.fill_(1.0)
        if not self.cfg.tie_embeddings:
            self.lm_head.copy_(L.dense_init(
                generator, self.lm_head.shape, self.lm_head.dtype,
                device=self.lm_head.device))
        return self

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b = batch or shape.global_batch
        dims = (cfg.n_layers, b, shape.seq_len, cfg.n_kv_heads,
                cfg.resolved_head_dim)
        dt = torch_dtype(cfg.dtype)
        return {"k": torch.zeros(dims, dtype=dt, device=self.device),
                "v": torch.zeros(dims, dtype=dt, device=self.device)}

    # ------------------------------------------------------------------ blocks
    def _positions(self, tokens, offset=0) -> torch.Tensor:
        b, s = tokens.shape
        if torch.is_tensor(offset):
            offset = offset.to(device=tokens.device, dtype=torch.int32)
            if offset.ndim == 1:
                offset = offset[:, None]           # per-slot offsets (B, 1)
        pos = torch.arange(s, dtype=torch.int32,
                           device=tokens.device)[None, :] + offset
        pos = pos.expand(b, s)
        if self.cfg.mrope_sections is not None:
            return torch.stack([pos, pos, pos], dim=-1)   # text-only stream
        return pos

    def _norm(self, x, weight):
        if self.cfg.norm == "rmsnorm":
            return L.rms_norm(x, weight)
        return L.layer_norm(x, weight, torch.zeros_like(weight))

    def _attn(self, w, x, rope, cache_kv=None, write_at=None, attn_len=None):
        """Returns the attention output. ``rope`` is the (cos, sin) pair of
        this step's positions. With ``cache_kv`` given, this step's K/V are
        written into it in place at ``write_at`` — a (rows, positions) index
        pair for per-slot lengths, a one-element position tensor for a scalar
        length — and attention runs over ``attn_len`` positions."""
        cfg, run = self.cfg, self.run
        b, s, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = self._norm(x, w["ln1"])
        q = torch.matmul(h, w["wq"]).reshape(b, s, hq, hd)
        k = torch.matmul(h, w["wk"]).reshape(b, s, hkv, hd)
        v = torch.matmul(h, w["wv"]).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, w["q_norm"])
            k = L.rms_norm(k, w["k_norm"])
        q = L.rotate(q, *rope)
        k = L.rotate(k, *rope)
        if cache_kv is None:
            o = ops.flash_attention(q, k, v, causal=True, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk, impl=run.attn_impl)
        else:
            ck, cv = cache_kv
            if isinstance(write_at, tuple):
                # per-slot lengths (continuous batching): scatter each row
                ck.index_put_(write_at, k[:, 0])
                cv.index_put_(write_at, v[:, 0])
            else:
                ck.index_copy_(1, write_at, k)
                cv.index_copy_(1, write_at, v)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=run.attn_impl)
        return torch.matmul(o.reshape(b, s, hq * hd), w["wo"])

    def _mlp(self, w, x):
        h = self._norm(x, w["ln2"])
        if self.cfg.moe is not None:
            return moe_ffn(self.cfg, self.run, w, h)
        if self.cfg.mlp == "swiglu":
            return L.swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
        return L.gelu_mlp(h, w["w_up"], w["b_up"], w["w_down"], w["b_down"])

    def _stack(self, x, pos, cache=None, cache_len=None):
        # the rotary tables depend on the positions only: once per step, not
        # once per layer and tensor as the reference's scan body does
        cfg = self.cfg
        if cfg.mrope_sections is not None:
            rope = L.mrope_tables(pos, cfg.resolved_head_dim,
                                  cfg.mrope_sections, cfg.rope_theta)
        else:
            rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        write_at = attn_len = None
        if cache is not None:
            # new K/V go to position cache_len, attention sees cache_len + 1
            attn_len = (cache_len + 1).to(torch.int32)
            if cache_len.ndim == 1:
                write_at = (torch.arange(x.shape[0], device=x.device),
                            cache_len)
            else:
                write_at = cache_len.reshape(1)
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            x = x + self._attn(w, x, rope, kv, write_at, attn_len)
            x = x + self._mlp(w, x)
        return x

    def _logits(self, x):
        x = self._norm(x, self.final_norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return torch.matmul(x, head)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward: batch = {tokens (B,S)} -> logits (B, S, V)."""
        tokens = batch["tokens"].to(self.device)
        x = self.embed[tokens.long()]
        x = self._stack(x, self._positions(tokens))
        return self._logits(x)

    def decode_step(self, cache, batch):
        """One decode step: batch = {tokens (B,1), cache_len () or (B,)} ->
        (logits (B, V), cache). ``cache`` is written in place."""
        tokens = batch["tokens"].to(self.device)
        cache_len = torch.as_tensor(batch["cache_len"], device=self.device)
        cache_len = cache_len.long()
        x = self.embed[tokens.long()]
        pos = self._positions(tokens, offset=cache_len)
        x = self._stack(x, pos, cache=cache, cache_len=cache_len)
        return self._logits(x)[:, -1], cache
