"""Zamba2 — hybrid Mamba-2 backbone with a *shared* attention block.

Counterpart of ``repro.models.ssm.Zamba2Model``: ``n_layers`` Mamba-2 mixer
blocks (in_proj split, width-4 causal depthwise conv with its tail state,
softplus ``dt``, ``A = -exp(A_log)``, the SSD scan, SiLU gate, out_proj);
after every ``attn_every`` of them one full-attention transformer block
whose weights are the SAME at every invocation point, each point with its
own KV cache. The SSD scan is the chunked kernel ``ops.ssd`` in ``forward``
and the single-token step ``ssd_decode`` in ``decode_step``; attention goes
through ``ops.flash_attention`` / ``ops.decode_attention`` as in
``DecoderLM``. Parameters keep the reference tree's keys: ``mamba.*`` with
leading ``(n_super, per_super)`` axes, ``shared.*``, ``embed``,
``final_norm``, ``lm_head``. ``loss_fn`` trains through the plain SSD and
attention forms (``attn_impl="plain"``: the kernels have no backward);
serving calls it under ``torch.inference_mode()``. ``decode_step`` writes
the caches in place and returns the cache it was given.

``decode_step`` takes one ``cache_len`` for the whole batch, as the
reference does (it broadcasts a scalar and writes the KV caches with one
``dynamic_update_slice``): a ``(B,)`` length whose entries differ raises
(ROADMAP §C), so this model serves through ``Replica.generate``, not
through the continuous batcher.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.chunked import ssd_decode
from repro_torch.models import layers as L
from repro_torch.models.api import RunConfig
from repro_torch.models.sharding import P


class Zamba2Model(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``."""
        super().__init__()
        s = cfg.ssm
        if s is None:
            raise ValueError(f"{cfg.name}: no SSMConfig")
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.d_inner = s.expand * cfg.d_model
        if self.d_inner % s.head_dim or cfg.n_layers % s.attn_every:
            raise ValueError("d_inner must be a multiple of the SSM head_dim "
                             "and n_layers a multiple of attn_every")
        self.n_ssm_heads = self.d_inner // s.head_dim
        self.n_super = cfg.n_layers // s.attn_every
        self.per_super = s.attn_every
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        dt = torch_dtype(cfg.dtype)

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.embed = param((cfg.vocab, cfg.d_model), dt)
        self.final_norm = param((cfg.d_model,), torch.float32)
        self.lm_head = param((cfg.d_model, cfg.vocab), dt)
        lead = (self.n_super, self.per_super)
        self.mamba = nn.ParameterDict({
            k: param(lead + shape, dtype)
            for k, (shape, dtype) in self._mamba_shapes().items()})
        self.shared = nn.ParameterDict({
            k: param(shape, dtype)
            for k, (shape, dtype) in self._shared_shapes().items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ params
    def _mamba_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        cfg = self.cfg
        s = cfg.ssm
        d, din, n, h = cfg.d_model, self.d_inner, s.d_state, self.n_ssm_heads
        dt, f32 = torch_dtype(cfg.dtype), torch.float32
        conv_ch = din + 2 * n
        return {
            "ln": ((d,), f32),
            "in_proj": ((d, 2 * din + 2 * n + h), dt),
            "conv_w": ((s.conv_width, conv_ch), f32),
            "conv_b": ((conv_ch,), f32),
            "A_log": ((h,), f32),
            "D": ((h,), f32),
            "dt_bias": ((h,), f32),
            "out_proj": ((din, d), dt),
        }

    def _shared_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        return {
            "ln1": ((d,), torch.float32),
            "wq": ((d, hq * hd), dt), "wk": ((d, hkv * hd), dt),
            "wv": ((d, hkv * hd), dt), "wo": ((hq * hd, d), dt),
            "ln2": ((d,), torch.float32),
            "w_gate": ((d, f), dt), "w_up": ((d, f), dt),
            "w_down": ((f, d), dt),
        }

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's ``param_pspecs``, keyed by ``state_dict`` name
        (read by ZeRO-1 and elastic restore; the model computes on one
        device, ROADMAP A13c)."""
        m = self.run.model_axis
        mamba = {"ln": P(None, None, None),
                 "in_proj": P(None, None, None, m),
                 "conv_w": P(None, None, None, m),
                 "conv_b": P(None, None, m),
                 "A_log": P(None, None, m), "D": P(None, None, m),
                 "dt_bias": P(None, None, m),
                 "out_proj": P(None, None, m, None)}
        shared = {"ln1": P(None), "wq": P(None, m), "wk": P(None, m),
                  "wv": P(None, m), "wo": P(m, None), "ln2": P(None),
                  "w_gate": P(None, m), "w_up": P(None, m),
                  "w_down": P(m, None)}
        out = {"embed": P(m, None), "final_norm": P(None),
               "lm_head": P(None, m)}
        out.update({f"mamba.{k}": v for k, v in mamba.items()})
        out.update({f"shared.{k}": v for k, v in shared.items()})
        return out

    def input_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes if shape.global_batch > 1 else None
        if shape.kind == "train":
            return {"tokens": P(dax, None), "labels": P(dax, None)}
        if shape.kind == "prefill":
            return {"tokens": P(dax, None)}
        return {"tokens": P(dax, None), "cache_len": P()}

    def cache_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes
        m = self.run.model_axis
        if shape.global_batch == 1:
            # long-context single-stream decode: sequence-parallel KV cache
            # (+ KV heads over the model axis); batch dim unshardable
            kv = P(None, None, dax, m, None)
            bax = None
        else:
            kv = P(None, dax, None, None, None)
            bax = dax
        return {"ssd": P(None, None, bax, m, None, None),
                "conv": P(None, None, bax, None, m),
                "k": kv, "v": kv}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    layer_fan_in: bool = False) -> "Zamba2Model":
        """Fill the parameters in place from ``generator`` with the
        reference's scales: norms 1; ``A_log = log(linspace(1, 8, H))``;
        ``D``, ``dt_bias``, ``conv_b`` 0; ``conv_w`` N(0, 0.2); the embedding
        N(0, 0.02); every other matrix N(0, 1/sqrt(fan_in)) with ``fan_in``
        read off the (stacked) shape, as in the reference. There the Mamba
        matrices' fan-in is ``n_super``, which at full width puts ``dt``
        near 17 and the residual stream near 1e7; ``layer_fan_in=True``
        draws them at 1/sqrt(their per-layer fan-in) instead (a deviation
        from the reference, for checks that need a well-conditioned model).
        """
        for k, p in self.mamba.items():
            if k == "ln":
                p.fill_(1.0)
            elif k == "A_log":
                p.copy_(torch.log(torch.linspace(
                    1.0, 8.0, p.shape[-1], dtype=torch.float32,
                    device=p.device)).expand(p.shape))
            elif k in ("D", "dt_bias", "conv_b"):
                p.zero_()
            elif k == "conv_w":
                p.copy_(L.dense_init(generator, p.shape, p.dtype, scale=0.2,
                                     device=p.device))
            else:
                scale = p.shape[-2] ** -0.5 if layer_fan_in else None
                p.copy_(L.dense_init(generator, p.shape, p.dtype, scale=scale,
                                     device=p.device))
        for k, p in self.shared.items():
            if k.startswith("ln"):
                p.fill_(1.0)
            else:
                p.copy_(L.dense_init(generator, p.shape, p.dtype,
                                     device=p.device))
        self.embed.copy_(L.dense_init(generator, self.embed.shape,
                                      self.embed.dtype, scale=0.02,
                                      device=self.device))
        self.final_norm.fill_(1.0)
        self.lm_head.copy_(L.dense_init(generator, self.lm_head.shape,
                                        self.lm_head.dtype,
                                        device=self.device))
        return self

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        s = cfg.ssm
        b, smax = batch or shape.global_batch, shape.seq_len
        ns, ps = self.n_super, self.per_super
        conv_ch = self.d_inner + 2 * s.d_state
        f32 = dict(dtype=torch.float32, device=self.device)
        kv = dict(dtype=torch_dtype(cfg.dtype), device=self.device)
        kv_dims = (ns, b, smax, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "ssd": torch.zeros((ns, ps, b, self.n_ssm_heads, s.head_dim,
                                s.d_state), **f32),
            "conv": torch.zeros((ns, ps, b, s.conv_width - 1, conv_ch),
                                **f32),
            "k": torch.zeros(kv_dims, **kv),
            "v": torch.zeros(kv_dims, **kv),
        }

    # ------------------------------------------------------------------ mamba
    def _conv(self, w, xbc, conv_state):
        """Causal depthwise conv via shifted adds. xbc: (B,S,CH);
        conv_state: (B, width-1, CH), the tail of the previous tokens.
        Returns (silu(conv), new tail)."""
        width = self.cfg.ssm.conv_width
        full = torch.cat([conv_state, xbc], dim=1)      # (B, S+w-1, CH)
        s = xbc.shape[1]
        out = torch.zeros_like(xbc)
        for i in range(width):
            out = out + full[:, i:i + s, :] * w["conv_w"][i]
        out = out + w["conv_b"]
        new_state = full[:, -(width - 1):, :] if width > 1 else conv_state
        return F.silu(out), new_state

    def _mamba_block(self, w, x, state, decode: bool):
        cfg, run = self.cfg, self.run
        s = cfg.ssm
        b, sq, _ = x.shape
        din, n, h, p = self.d_inner, s.d_state, self.n_ssm_heads, s.head_dim
        ssd_state, conv_state = state
        hn = L.rms_norm(x, w["ln"])
        proj = torch.matmul(hn.to(torch_dtype(cfg.dtype)),
                            w["in_proj"]).float()
        z = proj[..., :din]
        xbc, conv_new = self._conv(w, proj[..., din:2 * din + 2 * n],
                                   conv_state)
        dt = F.softplus(proj[..., 2 * din + 2 * n:] + w["dt_bias"])  # (B,S,H)
        a = -torch.exp(w["A_log"])
        # views, no copies: x is a slice of the conv output, B and C one
        # (B, S, N) slice each, broadcast over the heads
        xh = xbc[..., :din].reshape(b, sq, h, p)
        bh = xbc[..., din:din + n][:, :, None, :].expand(b, sq, h, n)
        ch = xbc[..., din + n:][:, :, None, :].expand(b, sq, h, n)
        if decode:
            y, ssd_new = ssd_decode(xh, dt, a, bh, ch, w["D"], ssd_state)
        else:
            y, ssd_new = ops.ssd(xh, dt, a, bh, ch, w["D"], ssd_state,
                                 chunk=run.seq_chunk, impl=run.attn_impl)
        y = y.reshape(b, sq, din) * F.silu(z)
        out = torch.matmul(y.to(torch_dtype(cfg.dtype)), w["out_proj"])
        return x + out, (ssd_new, conv_new)

    # ------------------------------------------------------------------ shared attention
    def _shared_block(self, x, rope, cache_kv=None, write_at=None,
                      attn_len=None):
        """The shared transformer block. With ``cache_kv`` given this step's
        K/V are written into it in place at position ``write_at`` and
        attention runs over ``attn_len`` positions."""
        cfg, run, w = self.cfg, self.run, self.shared
        b, sq, _ = x.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        dt = torch_dtype(cfg.dtype)
        h = L.rms_norm(x, w["ln1"]).to(dt)
        q = L.rotate(torch.matmul(h, w["wq"]).reshape(b, sq, hq, hd), *rope)
        k = L.rotate(torch.matmul(h, w["wk"]).reshape(b, sq, hkv, hd), *rope)
        v = torch.matmul(h, w["wv"]).reshape(b, sq, hkv, hd)
        if cache_kv is None:
            o = ops.flash_attention(q, k, v, causal=True, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk, impl=run.attn_impl)
        else:
            ck, cv = cache_kv
            ck.index_copy_(1, write_at, k)
            cv.index_copy_(1, write_at, v)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=run.attn_impl)
        x = x + torch.matmul(o.reshape(b, sq, hq * hd), w["wo"])
        h = L.rms_norm(x, w["ln2"]).to(dt)
        return x + L.swiglu(h, w["w_gate"], w["w_up"], w["w_down"])

    def _logits(self, x):
        return torch.matmul(L.rms_norm(x, self.final_norm), self.lm_head)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward from zero state: batch = {tokens (B,S)} -> logits
        (B, S, V). S must be a multiple of ``run.seq_chunk``."""
        cfg, s = self.cfg, self.cfg.ssm
        tokens = batch["tokens"].to(self.device)
        b, sq = tokens.shape
        x = self.embed[tokens.long()]
        pos = torch.arange(sq, dtype=torch.int32,
                           device=self.device)[None].expand(b, sq)
        rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        z = dict(dtype=torch.float32, device=self.device)
        state = (torch.zeros((b, self.n_ssm_heads, s.head_dim, s.d_state),
                             **z),
                 torch.zeros((b, s.conv_width - 1,
                              self.d_inner + 2 * s.d_state), **z))
        for i in range(self.n_super):
            for j in range(self.per_super):
                w = {k: p[i, j] for k, p in self.mamba.items()}
                x, _ = self._mamba_block(w, x, state, decode=False)
            x = self._shared_block(x, rope)
        return self._logits(x)

    def loss_fn(self, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` (B, S)."""
        return L.next_token_loss(self.forward(batch), batch["labels"])

    def decode_step(self, cache, batch):
        """One decode step: batch = {tokens (B,1), cache_len: one length for
        the batch (a scalar, or a (B,) tensor whose entries are equal)} ->
        (logits (B, V), cache). ``cache`` is written in place."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        cache_len = L.one_cache_len(
            torch.as_tensor(batch["cache_len"], device=self.device),
            "Zamba2Model")
        b = tokens.shape[0]
        x = self.embed[tokens.long()]
        pos = cache_len.to(torch.int32).reshape(1, 1).expand(b, 1)
        rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        write_at, attn_len = cache_len.reshape(1), cache_len + 1
        for i in range(self.n_super):
            for j in range(self.per_super):
                w = {k: p[i, j] for k, p in self.mamba.items()}
                x, (ssd_new, conv_new) = self._mamba_block(
                    w, x, (cache["ssd"][i, j], cache["conv"][i, j]),
                    decode=True)
                cache["ssd"][i, j].copy_(ssd_new)
                cache["conv"][i, j].copy_(conv_new)
            x = self._shared_block(x, rope, (cache["k"][i], cache["v"][i]),
                                   write_at, attn_len)
        return self._logits(x)[:, -1], cache
