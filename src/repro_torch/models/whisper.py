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
the reference scans (with ``RunConfig.remat`` each decoder layer of a
``forward`` that records gradients is checkpointed, ``models/remat.py``;
the encoder's are not, as in the reference), ``prefill_cross`` and ``decode_step`` writing the
cache in place and returning the cache they were given, and ``frames``
taken in the model's dtype (PyTorch multiplies no mixed dtypes; the
reference would promote an fp32 input to an fp32 residual stream).
``decode_step`` takes one ``cache_len`` for the batch, as the reference's
``dynamic_update_slice`` does: a (B,) length whose entries differ raises
(ROADMAP §C2).

**On a mesh** (built inside ``sharding.use_mesh(mesh)``) every parameter
is this rank's shard of ``param_pspecs()`` and, with a model axis of ``n``
ranks, the blocks run the tensor-parallel arithmetic GSPMD derives from
those specs, the collectives written out (each carries its gradient):
self and cross ``wq``/``wk``/``wv`` are split by columns, so K2 (causal,
non-causal and cross) and K1 (the self cache, the ``encoder_seq``-long
cross cache) run at the rank's ``ceil(H/n)`` heads (12 heads on 16 ranks
are padded with 4 zero heads, ``sharding.Padded``: a third more attention
work, on ranks 12-15 all of it padding; a padding head reads the cache's
last head and its output is masked to zeros); ``wo`` and ``w_down`` are
split by rows, then ``psum``; ``b_up`` is split with ``w_up``. The
embedding and the logits stay replicated (the vocabulary, 51,865, is not
divided by 4), and so are the caches (``cache_pspecs``): the new K/V heads
are gathered before every write, in ``decode_step`` and in
``prefill_cross``, and a rank attends at a contiguous copy of its heads.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import remat
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig
from repro_torch.models.sharding import P

MAX_DEC_POS = 32768 * 16 + 8   # the reference's, sized for its decode_32k cell


class WhisperModel(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``. Built inside
        ``sharding.use_mesh(mesh)``, every parameter is this rank's shard."""
        super().__init__()
        if cfg.enc_dec is None:
            raise ValueError(f"{cfg.name}: no EncDecConfig")
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.enc_layers = cfg.enc_dec.n_encoder_layers
        self.enc_seq = cfg.enc_dec.encoder_seq
        self.mesh = S.get_mesh()
        self.n_model = 1 if self.mesh is None \
            else self.mesh.size(self.run.model_axis)
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        self._full = self.param_shapes()
        specs = self.param_pspecs()

        def param(name):
            return S.shard_param(*self._full[name], specs[name], self.mesh,
                                 name, dev)

        for name in ("embed", "dec_pos", "enc_final_ln", "enc_final_lnb",
                     "dec_final_ln", "dec_final_lnb"):
            setattr(self, name, param(name))
        self.encoder = nn.ParameterDict({
            k: param(f"encoder.{k}") for k in self._enc_shapes()})
        self.decoder = nn.ParameterDict({
            k: param(f"decoder.{k}") for k in self._dec_shapes()})
        # this rank's heads: a slice of the caches', or an index where some
        # are padding (reading the last real head)
        hl, a, self._real = S.blocks_per_rank(cfg.n_heads,
                                              self.run.model_axis, self.mesh)
        self._mine = slice(a, a + hl) if self._real == hl else \
            torch.arange(a, a + hl).clamp(max=cfg.n_heads - 1)

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

    def _enc_shapes(self):
        return {**self._attn_shapes("s_"), **self._mlp_shapes()}

    def _dec_shapes(self):
        return {**self._attn_shapes("s_"), **self._attn_shapes("x_"),
                **self._mlp_shapes()}

    def param_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every parameter, by ``state_dict``
        name (the reference's ``param_specs``)."""
        cfg = self.cfg
        dt, f32, d = torch_dtype(cfg.dtype), torch.float32, cfg.d_model
        out = {"embed": ((cfg.vocab, d), dt), "dec_pos": ((MAX_DEC_POS, d), dt),
               "enc_final_ln": ((d,), f32), "enc_final_lnb": ((d,), f32),
               "dec_final_ln": ((d,), f32), "dec_final_lnb": ((d,), f32)}
        out.update({f"encoder.{k}": ((self.enc_layers,) + shape, dtype)
                    for k, (shape, dtype) in self._enc_shapes().items()})
        out.update({f"decoder.{k}": ((cfg.n_layers,) + shape, dtype)
                    for k, (shape, dtype) in self._dec_shapes().items()})
        return out

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's ``param_pspecs``, keyed by ``state_dict``
        name."""
        m = self.run.model_axis

        cfg = self.cfg
        heads = S.Padded(m, cfg.n_heads * cfg.resolved_head_dim,
                         cfg.resolved_head_dim)

        def spec(k, shape):
            if len(shape) == 1:          # stacked 1-d parameters: ndim 2
                return P(None, m) if k == "b_up" else P(None, None)
            if k.endswith(("wq", "wk", "wv")):
                return P(None, None, heads)
            if k.endswith("wo"):
                return P(None, heads, None)
            if k == "w_up":
                return P(None, None, m)
            if k == "w_down":
                return P(None, m, None)
            return P(None, None, None)

        enc, dec = self._enc_shapes(), self._dec_shapes()
        # vocab 51865 is not divisible by the model axis: replicate the
        # (tiny) embedding; logits stay replicated over `model`
        out = {"embed": P(None, None), "dec_pos": P(None, None),
               "enc_final_ln": P(None), "enc_final_lnb": P(None),
               "dec_final_ln": P(None), "dec_final_lnb": P(None)}
        out.update({f"encoder.{k}": spec(k, s) for k, (s, _) in enc.items()})
        out.update({f"decoder.{k}": spec(k, s) for k, (s, _) in dec.items()})
        return out

    def input_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes if shape.global_batch > 1 else None
        if shape.kind == "train":
            return {"frames": P(dax, None, None), "tokens": P(dax, None),
                    "labels": P(dax, None)}
        if shape.kind == "prefill":
            return {"frames": P(dax, None, None), "tokens": P(dax, None)}
        return {"tokens": P(dax, None), "cache_len": P()}

    def cache_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes if shape.global_batch > 1 else None
        kv = P(None, dax, None, None, None)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv}

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
        well-conditioned model), as ``Zamba2Model.init_params`` does. On a
        mesh every rank makes the single-device draw and keeps its
        slice."""
        specs = self.param_pspecs()
        for name, p in self.named_parameters():
            leaf = name.split(".")[-1]
            full = self._full[name][0]
            if "ln" in leaf and not leaf.endswith("b"):
                p.fill_(1.0)
            elif leaf.endswith(("lnb", "b_up", "b_down")):
                p.zero_()
            else:
                scale = 0.02 if leaf in ("embed", "dec_pos") else (
                    full[-2] ** -0.5 if layer_fan_in else None)
                t = L.dense_init(generator, full, p.dtype, scale=scale,
                                 device=p.device)
                p.copy_(S.keep_local(t, specs[name], self.mesh, name))
        return self

    def cache_shapes(self, shape: ShapeSpec, batch: Optional[int] = None
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of the self-attention KV cache (L, B,
        seq_len, H, D) and the cross K/V (L, B, encoder_seq, H, D)."""
        cfg = self.cfg
        b, dt = batch or shape.global_batch, torch_dtype(cfg.dtype)
        hq, hd, n = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
        self_kv = ((n, b, shape.seq_len, hq, hd), dt)
        cross = ((n, b, self.enc_seq, hq, hd), dt)
        return {"k": self_kv, "v": self_kv, "xk": cross, "xv": cross}

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed caches (``prefill_cross`` fills the cross K/V). On a mesh
        this rank's part of ``cache_pspecs`` (``batch`` is then the global
        batch)."""
        b = batch or shape.global_batch
        specs = None if self.mesh is None else self.cache_pspecs(
            ShapeSpec(shape.name, shape.seq_len, b, "decode"))
        return S.local_zeros(self.cache_shapes(shape, b), specs, self.mesh,
                             self.device)

    # ------------------------------------------------------------------ blocks
    def _heads(self, t):
        """(B, S, H·D) -> (B, S, H, D): this rank's heads on a mesh."""
        return t.reshape(t.shape[0], t.shape[1], -1,
                         self.cfg.resolved_head_dim)

    def _in(self, x):
        """A replicated activation entering this rank's columns."""
        return S.copy_to(x, self.run.model_axis, self.mesh)

    def _out(self, o, wo):
        """The row-parallel output projection, summed over the ranks; a
        padding head's output masked to zeros first (its ``wo`` rows are
        zero, but its gradient would not be)."""
        if self._real < o.shape[2]:
            o = o * (torch.arange(o.shape[2], device=o.device)
                     < self._real).to(o.dtype)[:, None]
        return S.psum_matmul(o.reshape(o.shape[0], o.shape[1], -1), wo,
                             self.run.model_axis, self.mesh)

    def _my_heads(self, t):
        """This rank's heads of a replicated cache (B, S, H, D), a
        contiguous copy."""
        if isinstance(self._mine, slice):
            return t[:, :, self._mine].contiguous()
        return t.index_select(2, self._mine.to(t.device))

    def _own(self, ck, cv, k, v, write_at=None):
        """Write this step's K/V heads into the replicated cache ``(ck,
        cv)`` (gathered over the model axis first; at ``write_at``, or the
        whole of it) and return the K/V this rank attends at: its heads, a
        contiguous copy on a mesh."""
        if self.n_model > 1:
            kv = S.all_gather(torch.stack([k, v]), self.run.model_axis, 3,
                              self.mesh)[:, :, :, :self.cfg.n_heads]
            k, v = kv[0], kv[1]
        if write_at is None:
            ck.copy_(k)
            cv.copy_(v)
        else:
            ck.index_copy_(1, write_at, k)
            cv.index_copy_(1, write_at, v)
        if self.n_model == 1:
            return ck, cv
        return self._my_heads(ck), self._my_heads(cv)

    def _self_attn(self, w, x, causal, cache_kv=None, write_at=None,
                   attn_len=None):
        """With ``cache_kv`` this step's K/V are written into it in place at
        position ``write_at`` and attention runs over ``attn_len``
        positions."""
        run = self.run
        h = self._in(L.layer_norm(x, w["s_ln"], w["s_lnb"]).to(
            torch_dtype(self.cfg.dtype)))
        q = self._heads(torch.matmul(h, w["s_wq"]))
        k = self._heads(torch.matmul(h, w["s_wk"]))
        v = self._heads(torch.matmul(h, w["s_wv"]))
        if cache_kv is None:
            o = ops.flash_attention(q, k, v, causal=causal, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk, impl=run.attn_impl)
        else:
            ck, cv = self._own(*cache_kv, k, v, write_at)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=run.attn_impl)
        return x + self._out(o, w["s_wo"])

    def _cross_q(self, w, x):
        h = L.layer_norm(x, w["x_ln"], w["x_lnb"]).to(torch_dtype(self.cfg.dtype))
        return self._heads(torch.matmul(self._in(h), w["x_wq"]))

    def _cross_attn(self, w, x, enc_kv):
        run = self.run
        ek, ev = enc_kv
        o = ops.flash_attention(self._cross_q(w, x), ek, ev, causal=False,
                                q_chunk=run.q_chunk, kv_chunk=run.kv_chunk,
                                impl=run.attn_impl)
        return x + self._out(o, w["x_wo"])

    def _enc_kv(self, w, enc_out):
        enc_out = self._in(enc_out)
        return (self._heads(torch.matmul(enc_out, w["x_wk"])),
                self._heads(torch.matmul(enc_out, w["x_wv"])))

    def _mlp(self, w, x):
        """``gelu_mlp`` with ``w_up``/``b_up`` split by columns and
        ``w_down`` by rows: the replicated ``b_down`` is added once, after
        the ``psum``."""
        h = L.layer_norm(x, w["mln"], w["mlnb"]).to(torch_dtype(self.cfg.dtype))
        down = functools.partial(S.psum_matmul, axes=self.run.model_axis,
                                 mesh=self.mesh)
        return x + L.gelu_mlp(self._in(h), w["w_up"], w["b_up"],
                              w["w_down"], w["b_down"], down)

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

        def block(x, w):
            x = self._self_attn(w, x, causal=True)
            x = self._cross_attn(w, x, self._enc_kv(w, enc_out))
            return self._mlp(w, x)

        # the decoder's layers are checkpointed, the encoder's are not, as
        # in the reference
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.decoder.items()}
            x = remat.layer(self.run, block, x, w)
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
            self._own(cache["xk"][i], cache["xv"][i], *self._enc_kv(w, enc_out))
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
            xk, xv = cache["xk"][i], cache["xv"][i]
            if self.n_model > 1:
                xk, xv = self._my_heads(xk), self._my_heads(xv)
            o = ops.decode_attention(self._cross_q(w, x), xk, xv, cross_len,
                                     impl=self.run.attn_impl)
            x = x + self._out(o, w["x_wo"])
            x = self._mlp(w, x)
        return self._logits(x)[:, -1], cache
