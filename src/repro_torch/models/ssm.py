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
with ``RunConfig.remat`` a ``forward`` that records gradients checkpoints
each mixer block and each call of the shared block on its own
(``models/remat.py``), as the reference does; serving calls it under ``torch.inference_mode()``. ``decode_step`` writes
the caches in place and returns the cache it was given.

``decode_step`` takes one ``cache_len`` for the whole batch, as the
reference does (it broadcasts a scalar and writes the KV caches with one
``dynamic_update_slice``): a ``(B,)`` length whose entries differ raises
(ROADMAP §C), so this model serves through ``Replica.generate``, not
through the continuous batcher.

**On a mesh** (built inside ``sharding.use_mesh(mesh)``) every parameter
is this rank's shard of ``param_pspecs()`` and, with a model axis of ``n``
ranks, the blocks run the tensor-parallel arithmetic GSPMD derives from
those specs, the collectives written out (each carries its gradient):

  * the packed ``in_proj`` is split into ``n`` column blocks that do not
    fall on its z / x / B / C / dt boundaries, and ``conv_w``/``conv_b``
    into ``n`` channel blocks that do not fall on the x heads (at
    zamba2-2.7b's width 2,612 of 10,448 columns and 1,312 of 5,248
    channels a rank, against 1,280-channel x blocks). GSPMD reshards that
    in the reference; here it is written out: the projection is gathered
    along its columns (``all_gather_rs``), the rank convolves its conv
    channels, the conv output is gathered along its channels, and the rank
    keeps its SSD heads of z, x and dt and all of B and C;
  * ``A_log``, ``D``, ``dt_bias`` and the rows of ``out_proj`` are split
    by heads, aligned, so SSD (K4 in ``forward``, ``ssd_decode`` in
    ``decode_step``) runs at the rank's ``H/n`` heads on its slice of the
    ssd state, and ``out_proj`` is followed by ``psum``; the conv state
    holds the rank's conv channels;
  * the shared block: ``wq``/``wk``/``wv`` split by columns (the rank's
    heads: K2 and K1 at ``H/n`` heads), ``wo`` and the MLP's ``w_down`` by
    rows, each followed by ``psum``;
  * the KV cache follows ``cache_pspecs``: for a batch above 1 it is
    replicated over the model axis, so a step gathers the new K/V heads
    before it writes them and attends at its heads (a contiguous copy of
    them); for a batch of 1 it holds the rank's heads, and where the data
    axes have more than one rank its sequence is split over them too (the
    reference's sequence-parallel ``long_500k`` layout): every data rank
    runs the same recurrence on the replicated token, the rank that owns
    the written position writes it, and the ranks' partial attentions
    merge over the data axes (``decode_attention_seq_sharded``: K1 with
    the rows' log-sum-exp, ``pmax`` and two ``psum``s). A batch of 1 on
    data ranks with a model axis of one rank is refused: its cache cannot
    be told from a batch split one row a rank;
  * the embedding is split over the vocabulary (a masked local lookup,
    then ``psum``) and ``lm_head`` by columns (the logits gathered).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.chunked import ssd_decode
from repro_torch.models import layers as L
from repro_torch.models import remat
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig
from repro_torch.models.distributed_attention import \
    decode_attention_seq_sharded
from repro_torch.models.sharding import P


class Zamba2Model(nn.Module):
    # decode_step takes one cache_len for the batch (``L.one_cache_len``)
    per_row_lengths = False

    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``. Built inside
        ``sharding.use_mesh(mesh)``, every parameter is this rank's shard."""
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

        self.embed = param("embed")
        self.final_norm = param("final_norm")
        self.lm_head = param("lm_head")
        self.mamba = nn.ParameterDict({
            k: param(f"mamba.{k}") for k in self._mamba_shapes()})
        self.shared = nn.ParameterDict({
            k: param(f"shared.{k}") for k in self._shared_shapes()})
        # this rank's SSD heads, conv channels and attention heads
        self._i = 0 if self.mesh is None \
            else self.mesh.index(self.run.model_axis)
        self._hl = self.n_ssm_heads // self.n_model
        self._chl = (self.d_inner + 2 * s.d_state) // self.n_model

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

    def param_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every parameter, by ``state_dict``
        name (the reference's ``param_specs``)."""
        cfg = self.cfg
        dt, lead = torch_dtype(cfg.dtype), (self.n_super, self.per_super)
        out = {"embed": ((cfg.vocab, cfg.d_model), dt),
               "final_norm": ((cfg.d_model,), torch.float32),
               "lm_head": ((cfg.d_model, cfg.vocab), dt)}
        out.update({f"mamba.{k}": (lead + shape, d)
                    for k, (shape, d) in self._mamba_shapes().items()})
        out.update({f"shared.{k}": v
                    for k, v in self._shared_shapes().items()})
        return out

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's ``param_pspecs``, keyed by ``state_dict``
        name."""
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
        On a mesh every rank makes the single-device draw and keeps its
        slice.
        """
        specs = self.param_pspecs()

        def keep(p, name, t):
            p.copy_(S.keep_local(t, specs[name], self.mesh, name))

        def draw(p, name, scale=None):
            full = self._full[name][0]
            keep(p, name, L.dense_init(generator, full, p.dtype, scale=scale,
                                       device=p.device))

        for k, p in self.mamba.items():
            full = self._full[f"mamba.{k}"][0]
            if k == "ln":
                p.fill_(1.0)
            elif k == "A_log":
                keep(p, f"mamba.{k}", torch.log(torch.linspace(
                    1.0, 8.0, full[-1], dtype=torch.float32,
                    device=p.device)).expand(full))
            elif k in ("D", "dt_bias", "conv_b"):
                p.zero_()
            elif k == "conv_w":
                draw(p, f"mamba.{k}", 0.2)
            else:
                draw(p, f"mamba.{k}",
                     full[-2] ** -0.5 if layer_fan_in else None)
        for k, p in self.shared.items():
            if k.startswith("ln"):
                p.fill_(1.0)
            else:
                draw(p, f"shared.{k}")
        draw(self.embed, "embed", 0.02)
        self.final_norm.fill_(1.0)
        draw(self.lm_head, "lm_head")
        return self

    def cache_shapes(self, shape: ShapeSpec, batch: Optional[int] = None
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every cache tensor."""
        cfg, s, f32 = self.cfg, self.cfg.ssm, torch.float32
        b, smax = batch or shape.global_batch, shape.seq_len
        ns, ps = self.n_super, self.per_super
        conv_ch = self.d_inner + 2 * s.d_state
        kv = ((ns, b, smax, cfg.n_kv_heads, cfg.resolved_head_dim),
              torch_dtype(cfg.dtype))
        return {"ssd": ((ns, ps, b, self.n_ssm_heads, s.head_dim, s.d_state),
                        f32),
                "conv": ((ns, ps, b, s.conv_width - 1, conv_ch), f32),
                "k": kv, "v": kv}

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed caches; on a mesh this rank's part of ``cache_pspecs``
        (``batch`` is then the global batch)."""
        b, specs = batch or shape.global_batch, None
        if self.mesh is not None:
            if b == 1 and self.mesh.size(self.run.data_axes) > 1 \
                    and self.n_model == 1:
                raise ValueError(
                    f"{self.cfg.name}: a batch of 1 on data axes of "
                    f"{self.mesh.size(self.run.data_axes)} ranks needs a "
                    "model axis of more than one rank, which tells its "
                    "sequence-parallel KV cache from a batch split by rows")
            specs = self.cache_pspecs(ShapeSpec(shape.name, shape.seq_len, b,
                                                "decode"))
        return S.local_zeros(self.cache_shapes(shape, b), specs, self.mesh,
                             self.device)

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
        """On a mesh, ``h`` SSD heads and ``chl`` conv channels are this
        rank's (the module docstring says how the packed projection is
        resharded); on one device they are all."""
        cfg, run, mesh, m = self.cfg, self.run, self.mesh, self.run.model_axis
        s = cfg.ssm
        b, sq, _ = x.shape
        din, n, p = self.d_inner, s.d_state, s.head_dim
        h, chl, i = self._hl, self._chl, self._i
        ssd_state, conv_state = state
        hn = L.rms_norm(x, w["ln"])
        # each rank keeps other columns of the gathered projection
        proj = S.all_gather_rs(torch.matmul(S.copy_to(
            hn.to(torch_dtype(cfg.dtype)), m, mesh), w["in_proj"]), m, -1,
            mesh).float()
        z = proj[..., i * h * p:(i + 1) * h * p]
        conv, conv_new = self._conv(
            w, proj[..., din + i * chl:din + (i + 1) * chl], conv_state)
        xbc = S.all_gather_rs(conv, m, -1, mesh)
        dt0 = 2 * din + 2 * n + i * h
        dt = F.softplus(proj[..., dt0:dt0 + h] + w["dt_bias"])  # (B,S,H)
        a = -torch.exp(w["A_log"])
        # views, no copies: x is a slice of the conv output, B and C one
        # (B, S, N) slice each, broadcast over the heads
        xh = xbc[..., i * h * p:(i + 1) * h * p].reshape(b, sq, h, p)
        bh = xbc[..., din:din + n][:, :, None, :].expand(b, sq, h, n)
        ch = xbc[..., din + n:][:, :, None, :].expand(b, sq, h, n)
        if decode:
            y, ssd_new = ssd_decode(xh, dt, a, bh, ch, w["D"], ssd_state)
        else:
            y, ssd_new = ops.ssd(xh, dt, a, bh, ch, w["D"], ssd_state,
                                 chunk=run.seq_chunk, impl=run.attn_impl)
        y = y.reshape(b, sq, h * p) * F.silu(z)
        out = S.psum_matmul(y.to(torch_dtype(cfg.dtype)), w["out_proj"], m,
                            mesh)
        return x + out, (ssd_new, conv_new)

    # ------------------------------------------------------------------ shared attention
    def _shared_block(self, x, rope, cache_kv=None, write_at=None,
                      attn_len=None):
        """The shared transformer block. With ``cache_kv`` given this step's
        K/V are written into it in place at position ``write_at`` and
        attention runs over ``attn_len`` positions."""
        cfg, run, w = self.cfg, self.run, self.shared
        mesh, m = self.mesh, run.model_axis
        b, sq, _ = x.shape
        hq, hkv = cfg.n_heads // self.n_model, cfg.n_kv_heads // self.n_model
        hd = cfg.resolved_head_dim
        dt = torch_dtype(cfg.dtype)
        h = S.copy_to(L.rms_norm(x, w["ln1"]).to(dt), m, mesh)
        q = L.rotate(torch.matmul(h, w["wq"]).reshape(b, sq, hq, hd), *rope)
        k = L.rotate(torch.matmul(h, w["wk"]).reshape(b, sq, hkv, hd), *rope)
        v = torch.matmul(h, w["wv"]).reshape(b, sq, hkv, hd)
        if cache_kv is None:
            o = ops.flash_attention(q, k, v, causal=True, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk, impl=run.attn_impl)
        elif self.n_model > 1 and cache_kv[0].shape[2] != cfg.n_kv_heads \
                and mesh.size(run.data_axes) > 1:
            # batch 1: the rank's heads of its data ranks' sequence slice
            o = decode_attention_seq_sharded(
                q, *cache_kv, k, v, write_at, seq_axes=run.data_axes,
                impl=run.attn_impl, mesh=mesh, gather_q=False)
        else:
            ck, cv = cache_kv
            if self.n_model > 1 and ck.shape[2] == cfg.n_kv_heads:
                # a cache replicated over the model axis: every rank writes
                # the gathered heads and attends at its own
                kv = S.all_gather(torch.stack([k, v]), m, 3, mesh)
                ck.index_copy_(1, write_at, kv[0])
                cv.index_copy_(1, write_at, kv[1])
                mine = slice(self._i * hkv, (self._i + 1) * hkv)
                ck, cv = ck[:, :, mine].contiguous(), \
                    cv[:, :, mine].contiguous()
            else:
                ck.index_copy_(1, write_at, k)
                cv.index_copy_(1, write_at, v)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=run.attn_impl)
        x = x + S.psum_matmul(o.reshape(b, sq, hq * hd), w["wo"], m, mesh)
        h = S.copy_to(L.rms_norm(x, w["ln2"]).to(dt), m, mesh)
        return x + L.swiglu(h, w["w_gate"], w["w_up"], w["w_down"],
                            functools.partial(S.psum_matmul, axes=m,
                                              mesh=mesh))

    def _embed(self, tokens):
        return S.vocab_lookup(self.embed, tokens, self.run.model_axis,
                              self.mesh)

    def _logits(self, x):
        return S.vocab_logits(L.rms_norm(x, self.final_norm), self.lm_head,
                              self.run.model_axis, self.mesh)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward from zero state: batch = {tokens (B,S)} -> logits
        (B, S, V). S must be a multiple of ``run.seq_chunk``."""
        cfg, s = self.cfg, self.cfg.ssm
        tokens = batch["tokens"].to(self.device)
        b, sq = tokens.shape
        x = self._embed(tokens)
        pos = torch.arange(sq, dtype=torch.int32,
                           device=self.device)[None].expand(b, sq)
        rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        z = dict(dtype=torch.float32, device=self.device)
        state = (torch.zeros((b, self._hl, s.head_dim, s.d_state), **z),
                 torch.zeros((b, s.conv_width - 1, self._chl), **z))

        def mamba(x, w):
            return self._mamba_block(w, x, state, decode=False)[0]

        # the reference checkpoints the mamba and the shared block each on
        # its own
        for i in range(self.n_super):
            for j in range(self.per_super):
                w = {k: p[i, j] for k, p in self.mamba.items()}
                x = remat.layer(self.run, mamba, x, w)
            x = remat.layer(self.run, self._shared_block, x, rope)
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
        x = self._embed(tokens)
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
