"""Whisper-small — encoder-decoder transformer backbone: the audio family.

Counterpart of ``repro.models.whisper.WhisperModel``. The audio front end
(mel + conv subsampling) is a stub there too: ``frames`` are precomputed
encoder frame embeddings (B, ``encoder_seq``, d_model). Pre-LN encoder with
bidirectional self-attention and sinusoidal positions; decoder with causal
self-attention, cross-attention to the encoder output and learned positions
(``dec_pos``); GELU MLPs; the head tied to ``embed``.

Parameters keep the reference tree's keys: ``embed``, ``dec_pos``
(``MAX_DEC_POS`` rows, as the reference, so the converter carries it),
``enc_final_ln[b]``, ``dec_final_ln[b]``, and ``encoder.*`` / ``decoder.*``
stacked on a leading ``L`` axis (``s_`` self-attention, ``x_`` cross-
attention, ``m``/``w_``/``b_`` MLP). Attention goes through
``repro_torch.kernels.ops`` with ``impl=run.attn_impl``, as in
``DecoderLM``:

  * encoder self-attention, non-causal at S = ``encoder_seq``: flash
    attention (K2);
  * decoder self-attention in ``forward``: K2 causal; cross-attention in
    ``forward``: K2 non-causal with Sq != Skv;
  * ``decode_step``: self-attention against the KV cache over
    ``cache_len + 1`` positions and cross-attention against the cached
    encoder K/V over all ``encoder_seq`` of them, both flash-decode (K1).

Differences that come with PyTorch's idiom: an ``nn.Module`` owning its
parameters (made with ``requires_grad=False``; ``loss_fn`` trains on the
plain forms, ``attn_impl="plain"``), a Python loop over the layers where
the reference scans, ``prefill_cross`` and ``decode_step`` writing the
cache in place and returning the cache they were given, and ``frames``
taken in the model's dtype (PyTorch multiplies no mixed dtypes; the
reference would promote an fp32 input to an fp32 residual stream).
``decode_step`` takes one ``cache_len`` for the batch, as the reference's
``dynamic_update_slice`` does: a (B,) length whose entries differ raises
(ROADMAP §C2).
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

MAX_DEC_POS = 32768 * 16 + 8   # the reference's, sized for its decode_32k cell


class WhisperModel(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``."""
        super().__init__()
        if cfg.enc_dec is None:
            raise ValueError(f"{cfg.name}: no EncDecConfig")
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.enc_layers = cfg.enc_dec.n_encoder_layers
        self.enc_seq = cfg.enc_dec.encoder_seq
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        dt, f32, d = torch_dtype(cfg.dtype), torch.float32, cfg.d_model

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.embed = param((cfg.vocab, d), dt)
        self.dec_pos = param((MAX_DEC_POS, d), dt)
        self.enc_final_ln, self.enc_final_lnb = param((d,), f32), \
            param((d,), f32)
        self.dec_final_ln, self.dec_final_lnb = param((d,), f32), \
            param((d,), f32)
        enc = {**self._attn_shapes("s_"), **self._mlp_shapes()}
        dec = {**self._attn_shapes("s_"), **self._attn_shapes("x_"),
               **self._mlp_shapes()}
        self.encoder = nn.ParameterDict({
            k: param((self.enc_layers,) + shape, dtype)
            for k, (shape, dtype) in enc.items()})
        self.decoder = nn.ParameterDict({
            k: param((cfg.n_layers,) + shape, dtype)
            for k, (shape, dtype) in dec.items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ params
    def _attn_shapes(self, prefix) -> Dict[str, Tuple[tuple, torch.dtype]]:
        cfg = self.cfg
        d, hd, hq = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
        dt, f32 = torch_dtype(cfg.dtype), torch.float32
        return {f"{prefix}ln": ((d,), f32), f"{prefix}lnb": ((d,), f32),
                f"{prefix}wq": ((d, hq * hd), dt),
                f"{prefix}wk": ((d, hq * hd), dt),
                f"{prefix}wv": ((d, hq * hd), dt),
                f"{prefix}wo": ((hq * hd, d), dt)}

    def _mlp_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        d, f = self.cfg.d_model, self.cfg.d_ff
        dt, f32 = torch_dtype(self.cfg.dtype), torch.float32
        return {"mln": ((d,), f32), "mlnb": ((d,), f32),
                "w_up": ((d, f), dt), "b_up": ((f,), f32),
                "w_down": ((f, d), dt), "b_down": ((d,), f32)}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    layer_fan_in: bool = False) -> "WhisperModel":
        """Fill the parameters in place from ``generator`` with the
        reference's rule on leaf names: a name holding ``ln`` and not ending
        in ``b`` is 1, ``*lnb``, ``b_up`` and ``b_down`` are 0, ``embed`` and
        ``dec_pos`` N(0, 0.02), every other matrix N(0, 1/sqrt(fan_in))
        with ``fan_in`` read off the stacked shape (``L``), as in the
        reference. At whisper-small's width that is 8x the per-layer scale
        (fan-in 12 for a 768-wide input): attention scores of std ~64, rows
        one-hot, and near-ties that two orderings of the same fp32
        arithmetic break differently (ROADMAP §C9). ``layer_fan_in=True``
        draws the matrices at 1/sqrt(their per-layer fan-in) instead (a
        deviation from the reference, for checks that need a
        well-conditioned model), as ``Zamba2Model.init_params`` does."""
        for name, p in self.named_parameters():
            leaf = name.split(".")[-1]
            if "ln" in leaf and not leaf.endswith("b"):
                p.fill_(1.0)
            elif leaf.endswith(("lnb", "b_up", "b_down")):
                p.zero_()
            else:
                scale = 0.02 if leaf in ("embed", "dec_pos") else (
                    p.shape[-2] ** -0.5 if layer_fan_in else None)
                p.copy_(L.dense_init(generator, p.shape, p.dtype, scale=scale,
                                     device=p.device))
        return self

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed self-attention KV cache (L, B, seq_len, H, D) and cross
        K/V (L, B, encoder_seq, H, D); ``prefill_cross`` fills the latter."""
        cfg = self.cfg
        b = batch or shape.global_batch
        hq, hd, n = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
        z = dict(dtype=torch_dtype(cfg.dtype), device=self.device)
        return {"k": torch.zeros((n, b, shape.seq_len, hq, hd), **z),
                "v": torch.zeros((n, b, shape.seq_len, hq, hd), **z),
                "xk": torch.zeros((n, b, self.enc_seq, hq, hd), **z),
                "xv": torch.zeros((n, b, self.enc_seq, hq, hd), **z)}

    # ------------------------------------------------------------------ blocks
    def _heads(self, t):
        cfg = self.cfg
        return t.reshape(t.shape[0], t.shape[1], cfg.n_heads,
                         cfg.resolved_head_dim)

    def _self_attn(self, w, x, causal, cache_kv=None, write_at=None,
                   attn_len=None):
        """With ``cache_kv`` this step's K/V are written into it in place at
        position ``write_at`` and attention runs over ``attn_len``
        positions."""
        run = self.run
        b, s, _ = x.shape
        h = L.layer_norm(x, w["s_ln"], w["s_lnb"]).to(torch_dtype(self.cfg.dtype))
        q = self._heads(torch.matmul(h, w["s_wq"]))
        k = self._heads(torch.matmul(h, w["s_wk"]))
        v = self._heads(torch.matmul(h, w["s_wv"]))
        if cache_kv is None:
            o = ops.flash_attention(q, k, v, causal=causal, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk, impl=run.attn_impl)
        else:
            ck, cv = cache_kv
            ck.index_copy_(1, write_at, k)
            cv.index_copy_(1, write_at, v)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=run.attn_impl)
        return x + torch.matmul(o.reshape(b, s, -1), w["s_wo"])

    def _cross_q(self, w, x):
        h = L.layer_norm(x, w["x_ln"], w["x_lnb"]).to(torch_dtype(self.cfg.dtype))
        return self._heads(torch.matmul(h, w["x_wq"]))

    def _cross_attn(self, w, x, enc_kv):
        run = self.run
        b, s, _ = x.shape
        ek, ev = enc_kv
        o = ops.flash_attention(self._cross_q(w, x), ek, ev, causal=False,
                                q_chunk=run.q_chunk, kv_chunk=run.kv_chunk,
                                impl=run.attn_impl)
        return x + torch.matmul(o.reshape(b, s, -1), w["x_wo"])

    def _enc_kv(self, w, enc_out):
        return (self._heads(torch.matmul(enc_out, w["x_wk"])),
                self._heads(torch.matmul(enc_out, w["x_wv"])))

    def _mlp(self, w, x):
        h = L.layer_norm(x, w["mln"], w["mlnb"]).to(torch_dtype(self.cfg.dtype))
        return x + L.gelu_mlp(h, w["w_up"], w["b_up"], w["w_down"],
                              w["b_down"])

    def _sinusoid(self, s, d):
        pos = torch.arange(s, dtype=torch.float32, device=self.device)[:, None]
        dim = torch.arange(d // 2, dtype=torch.float32,
                           device=self.device)[None, :]
        ang = pos / torch.pow(10000.0, 2 * dim / d)
        return torch.cat([torch.sin(ang), torch.cos(ang)],
                         dim=-1).to(torch_dtype(self.cfg.dtype))

    def encode(self, frames) -> torch.Tensor:
        """frames (B, encoder_seq, d_model) -> encoder output, same shape."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=torch_dtype(cfg.dtype))
        x = x + self._sinusoid(self.enc_seq, cfg.d_model)[None]
        for i in range(self.enc_layers):
            w = {k: p[i] for k, p in self.encoder.items()}
            x = self._mlp(w, self._self_attn(w, x, causal=False))
        return L.layer_norm(x, self.enc_final_ln, self.enc_final_lnb)

    def _embed(self, tokens, pos):
        x = self.embed[tokens.long()].to(torch_dtype(self.cfg.dtype))
        return x + self.dec_pos[pos][None]

    def _logits(self, x):
        x = L.layer_norm(x, self.dec_final_ln, self.dec_final_lnb)
        return torch.matmul(x, self.embed.T)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """batch = {frames (B, encoder_seq, d), tokens (B, S)} -> logits
        (B, S, V)."""
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"].to(self.device)
        x = self._embed(tokens, torch.arange(tokens.shape[1],
                                             device=self.device))
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.decoder.items()}
            x = self._self_attn(w, x, causal=True)
            x = self._cross_attn(w, x, self._enc_kv(w, enc_out))
            x = self._mlp(w, x)
        return self._logits(x)

    def loss_fn(self, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` (B, S)."""
        return L.next_token_loss(self.forward(batch), batch["labels"])

    def prefill_cross(self, frames, cache):
        """Encode ``frames`` and write each decoder layer's cross-attention
        K/V into ``cache`` in place; returns ``cache``."""
        enc_out = self.encode(frames)
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.decoder.items()}
            ek, ev = self._enc_kv(w, enc_out)
            cache["xk"][i].copy_(ek)
            cache["xv"][i].copy_(ev)
        return cache

    def decode_step(self, cache, batch):
        """One decode step: batch = {tokens (B,1), cache_len: one length for
        the batch (a scalar, or a (B,) tensor whose entries are equal)} ->
        (logits (B, V), cache). ``cache`` (after ``prefill_cross``) is
        written in place."""
        tokens = batch["tokens"].to(self.device)
        cache_len = L.one_cache_len(
            torch.as_tensor(batch["cache_len"], device=self.device),
            "WhisperModel")
        b = tokens.shape[0]
        write_at = cache_len.reshape(1)
        x = self._embed(tokens, write_at)
        attn_len = cache_len + 1
        cross_len = torch.full((b,), self.enc_seq, dtype=torch.int32,
                               device=self.device)
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.decoder.items()}
            x = self._self_attn(w, x, causal=True,
                                cache_kv=(cache["k"][i], cache["v"][i]),
                                write_at=write_at, attn_len=attn_len)
            o = ops.decode_attention(self._cross_q(w, x), cache["xk"][i],
                                     cache["xv"][i], cross_len,
                                     impl=self.run.attn_impl)
            x = x + torch.matmul(o.reshape(b, 1, -1), w["x_wo"])
            x = self._mlp(w, x)
        return self._logits(x)[:, -1], cache
