"""Decoder-only transformer LM: the dense, moe and vlm families (serving
paths).

Counterpart of ``repro.models.transformer.DecoderLM``. Differences that come
with PyTorch's idiom:

  * it is an ``nn.Module`` that owns its parameters; they keep the reference
    tree's keys and the stacked leading ``L`` axis (``embed``,
    ``final_norm``, ``layers.{ln1,ln2,wq,wk,wv,wo,...}``, optional
    ``lm_head``), so one converter serves every model;
  * a Python loop over ``L`` stands where the reference scans, and there
    is no sharding constraint (the mesh below); with ``RunConfig.remat``
    each layer of a forward that records gradients is checkpointed
    (``models/remat.py``, ``remat_policy`` "full" or "dots"), as the
    reference wraps its scan body in ``jax.checkpoint``;
  * attention goes through ``repro_torch.kernels.ops``: with
    ``RunConfig.attn_impl == "kernel"`` a CUDA tensor reaches the
    hand-written flash-attention (``forward``) and flash-decode
    (``decode_step``) kernels;
  * **the KV cache is updated in place** (``index_put_`` for per-slot
    lengths, ``index_copy_`` for a scalar length) where the reference
    returns a new array; ``decode_step`` still returns ``(logits, cache)``
    and the returned cache is the one passed in;
  * on one device with per-slot lengths and RMSNorm, ``decode_step`` takes
    the fused route (``_use_fused_decode``, ``_fused_stack``): the same
    arithmetic with each residual add fused into the norm after it, the
    rotation into the KV write and ``silu(g) * u`` into one pass
    (``kernels/fused_decode.py``), which on CUDA tensors are three
    hand-written kernels, so a captured step holds ~13 graph nodes a layer
    instead of ~49;
  * MoE layers (``cfg.moe``) run the single-device ``models/moe.py`` path
    in place of the dense MLP; the vlm family rotates by M-RoPE with the
    text-only position stream ``(pos, pos, pos)``, as the reference does
    (its vision front end is a stub);
  * ``loss_fn`` (the reference's arithmetic) trains through the plain
    attention forms: parameters are made with ``requires_grad=False`` for
    serving, a trainer turns them on with ``requires_grad_(True)``, and a
    kernel refuses an input that requires grad, so training runs with
    ``RunConfig(attn_impl="plain")``. Serving calls it under
    ``torch.inference_mode()``.

**On a mesh** (``models/sharding.py``: the model is built inside
``use_mesh(mesh)``) every parameter is allocated at its
local shard of ``param_pspecs()``, and when the mesh's model axis has more
than one rank ``forward`` and ``decode_step`` run the tensor-parallel
arithmetic that GSPMD derives from those specs in the reference
(Megatron-style), with the collectives written out:

  * ``embed`` is split over the vocabulary (``P(m, None)``, padded with
    zero rows where the ranks do not divide it): a masked local lookup,
    then a ``psum``; ``lm_head`` (or the tied embedding) is split over the
    vocabulary too, and the logits are all-gathered and cut to the
    vocabulary, so every rank returns ``(B_local, S, V)``;
  * ``wq`` is split by columns, giving the rank its ``ceil(Hq / n)``
    heads: where ``n`` does not divide ``Hq`` (smollm's 15 on 4 or 16
    ranks, arctic's 56 on 16) the heads are padded with zero heads, as
    GSPMD pads them (``sharding.Padded``), and a padding head's output is
    masked to exact zeros, so neither it nor its gradient reaches the
    sum; ``wk``/``wv`` are replicated when the config has fewer than 16
    KV heads (every shipped one) and the rank keeps the KV heads its
    query heads read, ``[a // g, (b - 1) // g + 1)`` for heads ``[a, b)``
    (a padding head reads the last one); with 16 KV heads or more they are
    split by columns with the cache's head axis (the reference's
    KV-head-sharded layout), and the rank attends at its own ``Hkv / n``
    KV heads; K2 (prefill) or K1 (decode) runs at the local heads; ``wo``
    is split by rows, then ``psum``;
  * the dense MLP splits by columns (``w_gate``, ``w_up``, ``b_up``) and
    rows (``w_down``), then ``psum``; MoE layers go to ``moe_ffn``'s
    expert-parallel branch;
  * the batch is this rank's rows of ``input_pspecs`` (the caller splits
    it); activations are replicated over the model axis;
  * the KV cache is this rank's part of ``cache_pspecs``: sequence-sharded
    over the model axis (``init_cache`` makes it), or, with 16 KV heads or
    more, split by KV heads, which a rank writes and reads as one device
    does. The sequence-sharded cache's decode follows the
    reference's branches: per-slot ``(B,)`` lengths scatter each row into
    the rank that owns its position, then attend over the whole cache; a
    scalar length with ``RunConfig.sharded_decode`` runs the distributed
    flash-decode (``models/distributed_attention.py``); otherwise the
    owner writes and the attention runs over the whole cache. "The whole
    cache" is the slices all-gathered first, as GSPMD's baseline does: a
    step moves every layer's cache, ``2 · L · B · Smax · Hkv · D`` elements,
    through the collective, where the sharded decode moves ``O(B · Hq ·
    D)`` per layer.

Training runs on the same arithmetic: every collective carries its
gradient (``sharding``'s variants), ``copy_to`` stands at every input of a
column-parallel matmul (``wq``, the MLP, the head) and on the replicated
values per-rank compute reads (the K/V a rank picks its heads from,
``q_norm``), so the gradient of a replicated leaf is the whole one on every
rank and a sharded leaf's is its slice; the vocabulary-split lookup's
``psum`` hands each rank its rows' gradient. Padding stays exactly 0: its
gradient is 0 (masked head outputs, dropped logit columns, rows no token
looks up), so AdamW leaves it 0, and ``sharding.gather`` drops it before a
checkpoint or ``convert`` sees it. With no mesh the code path is the
single-device one.
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
from repro_torch.models.distributed_attention import (
    decode_attention_seq_sharded, write_owned)
from repro_torch.models.moe import (init_moe_param, moe_ffn,
                                    moe_param_pspecs, moe_param_shapes)
from repro_torch.models.sharding import P


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``. Built inside
        ``sharding.use_mesh(mesh)``, every parameter is this rank's shard."""
        super().__init__()
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.mesh = S.get_mesh()
        self.n_model = 1 if self.mesh is None \
            else self.mesh.size(self.run.model_axis)
        # the reference's layout for 16 KV heads or more: K/V split by heads
        self._kv_sharded = self.n_model > 1 and cfg.n_kv_heads >= 16
        if self._kv_sharded and cfg.n_kv_heads % self.n_model:
            raise ValueError(
                f"{cfg.name}: {cfg.n_kv_heads} KV heads do not split over "
                f"{self.n_model} ranks of the model axis")
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        self._full = self.param_shapes()
        specs = self.param_pspecs()

        def param(name):
            return S.shard_param(*self._full[name], specs[name], self.mesh,
                                 name, dev)

        self.embed = param("embed")
        self.final_norm = param("final_norm")
        self.layers = nn.ParameterDict({
            k: param(f"layers.{k}") for k in self._layer_shapes()})
        if not cfg.tie_embeddings:
            self.lm_head = param("lm_head")

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

    def param_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every parameter, by ``state_dict``
        name (the reference's ``param_specs``)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        out = {"embed": ((cfg.vocab, cfg.d_model), dt),
               "final_norm": ((cfg.d_model,), torch.float32)}
        out.update({f"layers.{k}": ((cfg.n_layers,) + shape, d)
                    for k, (shape, d) in self._layer_shapes().items()})
        if not cfg.tie_embeddings:
            out["lm_head"] = ((cfg.d_model, cfg.vocab), dt)
        return out

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's ``param_pspecs``, keyed by ``state_dict`` name."""
        cfg, m = self.cfg, self.run.model_axis
        # query heads split by whole heads, zero heads padding the split
        heads = S.Padded(m, cfg.n_heads * cfg.resolved_head_dim,
                         cfg.resolved_head_dim)
        vocab = S.Padded(m, cfg.vocab)
        layers = {"ln1": P(None, None), "ln2": P(None, None),
                  "wq": P(None, None, heads), "wo": P(None, heads, None)}
        # KV projections: shard heads on the model axis only when there are
        # enough KV heads; MQA/GQA-with-few-heads replicates KV (cheap)
        kv = P(None, None, m) if cfg.n_kv_heads >= 16 else P(None, None, None)
        layers["wk"] = layers["wv"] = kv
        if cfg.qk_norm:
            layers["q_norm"] = layers["k_norm"] = P(None, None)
        if cfg.moe is not None:
            layers.update(moe_param_pspecs(
                cfg, m, fsdp_axes=(self.run.data_axes
                                   if self.run.fsdp_experts else None)))
        elif cfg.mlp == "swiglu":
            layers.update({"w_gate": P(None, None, m),
                           "w_up": P(None, None, m),
                           "w_down": P(None, m, None)})
        else:
            layers.update({"w_up": P(None, None, m), "b_up": P(None, m),
                           "w_down": P(None, m, None),
                           "b_down": P(None, None)})
        out = {"embed": P(vocab, None), "final_norm": P(None)}
        out.update({f"layers.{k}": v for k, v in layers.items()})
        if not cfg.tie_embeddings:
            out["lm_head"] = P(None, vocab)
        return out

    def input_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes if shape.global_batch > 1 else None
        if shape.kind == "train":
            return {"tokens": P(dax, None), "labels": P(dax, None)}
        if shape.kind == "prefill":
            return {"tokens": P(dax, None)}
        return {"tokens": P(dax, None), "cache_len": P()}

    def cache_pspecs(self, shape: ShapeSpec) -> Dict[str, P]:
        dax = self.run.data_axes if shape.global_batch > 1 else None
        m = self.run.model_axis
        if self.cfg.n_kv_heads >= 16:
            kv = P(None, dax, None, m, None)     # shard KV heads
        else:
            kv = P(None, dax, m, None, None)     # shard cache sequence
        return {"k": kv, "v": kv}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    layer_fan_in: bool = False) -> "DecoderLM":
        """Fill the parameters in place from ``generator`` (which must live
        on the parameters' device). Scales are the reference's: norms 1,
        biases 0, embeddings N(0, 0.02), every other matrix
        N(0, 1/sqrt(fan_in)) with ``fan_in`` read off the stacked shape;
        the MoE keys follow ``moe.init_moe_param`` (their own fan-in). The
        stacked fan-in (``L``) makes attention rows near one-hot at full
        width (ROADMAP §C4); ``layer_fan_in=True`` draws the layer matrices
        at 1/sqrt(their per-layer fan-in) instead (a deviation from the
        reference, for checks that need a well-conditioned model), as
        ``Zamba2Model.init_params`` does. On a mesh every rank makes the
        single-device draw and keeps its slice, so the shards equal the
        slices of the single-device parameters exactly: a stacked dense
        matrix is drawn whole, as on one device; the experts, one
        (layer, expert) matrix at a time (``init_moe_param``), so that no
        rank ever holds a whole expert tensor."""
        moe_keys = moe_param_shapes(self.cfg) if self.cfg.moe else {}
        specs = self.param_pspecs()

        def fill(p, name, scale=None):
            t = L.dense_init(generator, self._full[name][0], p.dtype,
                             scale=scale, device=p.device)
            p.copy_(S.keep_local(t, specs[name], self.mesh, name))

        for k, p in self.layers.items():
            if k in moe_keys:
                name = f"layers.{k}"
                full = self._full[name][0]
                init_moe_param(generator, k, p, full, None if self.mesh is None
                               else S.local_slices(full, specs[name],
                                                   self.mesh, name))
            elif k.startswith("ln") or k.endswith("norm"):
                p.fill_(1.0)
            elif k.startswith("b_"):
                p.zero_()
            else:
                fill(p, f"layers.{k}", self._full[f"layers.{k}"][0][-2]
                     ** -0.5 if layer_fan_in else None)
        fill(self.embed, "embed", 0.02)
        self.final_norm.fill_(1.0)
        if not self.cfg.tie_embeddings:
            fill(self.lm_head, "lm_head")
        return self

    def cache_shapes(self, shape: ShapeSpec, batch: Optional[int] = None
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of the K and V caches."""
        cfg = self.cfg
        kv = ((cfg.n_layers, batch or shape.global_batch, shape.seq_len,
               cfg.n_kv_heads, cfg.resolved_head_dim), torch_dtype(cfg.dtype))
        return {"k": kv, "v": kv}

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache; on a mesh this rank's part of
        ``cache_pspecs`` (``batch`` is then the global batch)."""
        b = batch or shape.global_batch
        specs = None if self.mesh is None else self.cache_pspecs(
            ShapeSpec(shape.name, shape.seq_len, b, "decode"))
        return S.local_zeros(self.cache_shapes(shape, b), specs, self.mesh,
                             self.device)

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

    def _qkv(self, w, h, hq, hkv):
        """q, k, v (B, S, H, D) of the normed input ``h`` at ``hq`` /
        ``hkv`` heads, qk-normed where the configuration says."""
        cfg, m, mesh = self.cfg, self.run.model_axis, self.mesh
        b, s, _ = h.shape
        hd = cfg.resolved_head_dim
        q = torch.matmul(h, w["wq"]).reshape(b, s, hq, hd)
        k = torch.matmul(h, w["wk"]).reshape(b, s, hkv, hd)
        v = torch.matmul(h, w["wv"]).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, S.copy_to(w["q_norm"], m, mesh))
            k = L.rms_norm(k, S.copy_to(w["k_norm"], m, mesh))
        return q, k, v

    def _attn(self, w, x, rope, cache_kv=None, write_at=None, attn_len=None):
        """Returns the attention output. ``rope`` is the (cos, sin) pair of
        this step's positions. With ``cache_kv`` given, this step's K/V are
        written into it in place at ``write_at`` — a (rows, positions) index
        pair for per-slot lengths, a one-element position tensor for a scalar
        length — and attention runs over ``attn_len`` positions. On a mesh
        whose KV heads are split (``_kv_sharded``) these are the rank's
        ``Hq / n`` query and ``Hkv / n`` KV heads on its part of the cache,
        the projections' input through ``copy_to`` and ``wo``'s rows
        summed; with one rank of the model axis both are identities."""
        cfg, run, mesh, m = self.cfg, self.run, self.mesh, self.run.model_axis
        b, s, _ = x.shape
        hq, hkv = cfg.n_heads // self.n_model, cfg.n_kv_heads // self.n_model
        hd = cfg.resolved_head_dim
        h = S.copy_to(self._norm(x, w["ln1"]), m, mesh)
        q, k, v = self._qkv(w, h, hq, hkv)
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
        return S.psum_matmul(o.reshape(b, s, hq * hd), w["wo"], m, mesh)

    def _mlp(self, w, x):
        return self._ffn(w, self._norm(x, w["ln2"]))

    def _ffn(self, w, h):
        """The MoE, or the dense MLP split by columns and rows, then
        ``psum`` on a mesh (with one rank of the model axis ``copy_to`` is
        the identity and ``psum_matmul`` the plain product), of the normed
        input ``h``."""
        if self.cfg.moe is not None:
            return moe_ffn(self.cfg, self.run, w, h, mesh=self.mesh)
        m = self.run.model_axis
        hm = S.copy_to(h, m, self.mesh)
        down = functools.partial(S.psum_matmul, axes=m, mesh=self.mesh)
        if self.cfg.mlp == "swiglu":
            return L.swiglu(hm, w["w_gate"], w["w_up"], w["w_down"], down)
        return L.gelu_mlp(hm, w["w_up"], w["b_up"], w["w_down"], w["b_down"],
                          down)

    def _rope(self, pos):
        """The (cos, sin) tables of ``pos``. They depend on the positions
        only: once per step, not once per layer and tensor as the
        reference's scan body does."""
        cfg = self.cfg
        if cfg.mrope_sections is not None:
            return L.mrope_tables(pos, cfg.resolved_head_dim,
                                  cfg.mrope_sections, cfg.rope_theta)
        return L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)

    def _stack(self, x, pos, cache=None, cache_len=None):
        rope = self._rope(pos)
        write_at = attn_len = None
        if cache is not None:
            # new K/V go to position cache_len, attention sees cache_len + 1
            attn_len = (cache_len + 1).to(torch.int32)
            if cache_len.ndim == 1:
                write_at = (torch.arange(x.shape[0], device=x.device),
                            cache_len)
            else:
                write_at = cache_len.reshape(1)
        attn = self._attn_tp if self.n_model > 1 and not self._kv_sharded \
            else self._attn

        def block(x, w, kv):
            x = x + attn(w, x, rope, kv, write_at, attn_len)
            return x + self._mlp(w, x)

        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            if cache is None:       # the reference's remat: no decode step
                x = remat.layer(self.run, block, x, w, None,
                                policy=self.run.remat_policy)
            else:
                x = block(x, w, (cache["k"][i], cache["v"][i]))
        return x

    def _embed(self, tokens):
        return S.vocab_lookup(self.embed, tokens, self.run.model_axis,
                              self.mesh)

    def _logits(self, x):
        return self._head(self._norm(x, self.final_norm))

    def _head(self, h):
        """Logits of the final norm's output ``h``."""
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return S.vocab_logits(h, head, self.run.model_axis, self.mesh,
                              self.cfg.vocab)

    # ------------------------------------------------------------- on a mesh
    def _local_heads(self):
        """This rank's query heads ``[a, a + hl)`` (``hl = ceil(Hq / n)``),
        how many of them are real (the rest pad), and the KV heads they
        read: a slice of the KV heads when the groups align with the split,
        else one KV head per query head (an index; a padding head reads
        the last KV head)."""
        cfg = self.cfg
        hl, a, real = S.blocks_per_rank(cfg.n_heads, self.run.model_axis,
                                        self.mesh)
        g = cfg.n_heads // cfg.n_kv_heads
        if real == hl and (hl % g == 0 or g % hl == 0):
            return a, hl, real, slice(a // g, (a + hl - 1) // g + 1)
        heads = torch.arange(a, a + hl, device=self.device)
        return a, hl, real, heads.clamp(max=cfg.n_heads - 1) // g

    @staticmethod
    def _pick(t, kv):
        """KV heads ``kv`` (a slice or an index) of (B, S, Hkv, D)."""
        t = t[:, :, kv] if isinstance(kv, slice) else t.index_select(2, kv)
        return t.contiguous()

    def _attn_tp(self, w, x, rope, cache_kv=None, write_at=None,
                 attn_len=None):
        """``_attn`` at this rank's heads: column-split ``wq``, replicated
        ``wk``/``wv``, row-split ``wo`` and its ``psum``. The cache is this
        rank's slice of the sequence. A padding head's output is masked to
        zeros (its ``wo`` rows are zero, but its gradient would not be)."""
        cfg, run, mesh = self.cfg, self.run, self.mesh
        m = run.model_axis
        b, s, _ = x.shape
        hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        a, hl, real, kv = self._local_heads()
        h = self._norm(x, w["ln1"])
        q = torch.matmul(S.copy_to(h, m, mesh), w["wq"]).reshape(b, s, hl, hd)
        k = torch.matmul(h, w["wk"]).reshape(b, s, hkv, hd)
        v = torch.matmul(h, w["wv"]).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, S.copy_to(w["q_norm"], m, mesh))
            k = L.rms_norm(k, w["k_norm"])
        q = L.rotate(q, *rope)
        # the replicated K/V, of which this rank reads its heads
        k = S.copy_to(L.rotate(k, *rope), m, mesh)
        v = S.copy_to(v, m, mesh)
        if cache_kv is None:
            o = ops.flash_attention(q, self._pick(k, kv), self._pick(v, kv),
                                    causal=True, q_chunk=run.q_chunk,
                                    kv_chunk=run.kv_chunk,
                                    impl=run.attn_impl)
        else:
            ck, cv = cache_kv
            pos = write_at[1] if isinstance(write_at, tuple) else write_at
            if not isinstance(write_at, tuple) and self._use_sharded_decode():
                o = decode_attention_seq_sharded(
                    q, ck, cv, k, v, pos, seq_axes=m, impl=run.attn_impl,
                    mesh=mesh, n_heads=cfg.n_heads)
                extra = hl * self.n_model - cfg.n_heads
                if extra:
                    o = torch.nn.functional.pad(o, (0, 0, 0, extra))
                o = o[:, :, a:a + hl]
            else:
                # the owner writes; attention over the gathered cache
                start = mesh.index(m) * ck.shape[1]
                write_owned(ck, k, pos, start)
                write_owned(cv, v, pos, start)
                o = ops.decode_attention(
                    q, self._pick(S.all_gather(ck, m, 1, mesh), kv),
                    self._pick(S.all_gather(cv, m, 1, mesh), kv), attn_len,
                    impl=run.attn_impl)
        if real < hl:
            o = o * (torch.arange(hl, device=o.device) < real).to(
                o.dtype)[:, None]
        return S.psum_matmul(o.reshape(b, s, hl * hd), w["wo"], m, mesh)

    def _use_sharded_decode(self) -> bool:
        """The explicit distributed flash-decode when the cache is
        sequence-sharded (few KV heads) over a model axis of several ranks."""
        return self.run.sharded_decode and self.n_model > 1 \
            and not self._kv_sharded

    # ------------------------------------------------------- fused decode
    def _use_fused_decode(self, cache_len) -> bool:
        """The decode step's fused route (``_fused_stack``): per-slot
        ``(B,)`` lengths, one device, RMSNorm. Everything else (a scalar
        length, a mesh, layer norm) takes ``_stack``."""
        return cache_len.ndim == 1 and self.mesh is None \
            and self.cfg.norm == "rmsnorm"

    def _fused_stack(self, x, pos, cache, cache_len):
        """``_stack``'s decode layers and ``_logits``'s final norm with the
        non-product passes fused (``kernels/fused_decode.py``): each
        residual add goes into the norm after it (``add_rms_norm``, the
        last into ``final_norm``), the rotation into the KV write
        (``rope_kv_write``), the dense MLP's ``silu(g) * u`` into one pass
        (``silu_mul``); the products stay on ``torch.matmul``, attention
        on K1, the MoE on ``moe_ffn``. Returns the final norm's output.
        Every pass rounds where the unfused one does; on CPU tensors each
        is the unfused composition, so the logits and caches are bit for
        bit ``_stack``'s."""
        cfg, impl = self.cfg, self.run.attn_impl
        rope = self._rope(pos)
        attn_len = (cache_len + 1).to(torch.int32)
        b, s, _ = x.shape
        hq, hd = cfg.n_heads, cfg.resolved_head_dim
        delta = None
        for i in range(cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            ck, cv = cache["k"][i], cache["v"][i]
            x, h = ops.add_rms_norm(x, delta, w["ln1"], impl=impl)
            q, k, v = self._qkv(w, h, hq, cfg.n_kv_heads)
            q = ops.rope_kv_write(q, k, v, *rope, ck, cv, cache_len,
                                  impl=impl)
            o = ops.decode_attention(q, ck, cv, attn_len, impl=impl)
            x, h = ops.add_rms_norm(
                x, torch.matmul(o.reshape(b, s, hq * hd), w["wo"]),
                w["ln2"], impl=impl)
            if cfg.moe is None and cfg.mlp == "swiglu":
                delta = torch.matmul(ops.silu_mul(
                    torch.matmul(h, w["w_gate"]), torch.matmul(h, w["w_up"]),
                    impl=impl), w["w_down"])
            else:
                delta = self._ffn(w, h)
        return ops.add_rms_norm(x, delta, self.final_norm, impl=impl)[1]

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward: batch = {tokens (B,S)} -> logits (B, S, V)."""
        tokens = batch["tokens"].to(self.device)
        x = self._embed(tokens)
        x = self._stack(x, self._positions(tokens))
        return self._logits(x)

    def loss_fn(self, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` (B, S)."""
        return L.next_token_loss(self.forward(batch), batch["labels"])

    def decode_step(self, cache, batch):
        """One decode step: batch = {tokens (B,1), cache_len () or (B,)} ->
        (logits (B, V), cache). ``cache`` is written in place."""
        tokens = batch["tokens"].to(self.device)
        cache_len = torch.as_tensor(batch["cache_len"], device=self.device)
        cache_len = cache_len.long()
        x = self._embed(tokens)
        pos = self._positions(tokens, offset=cache_len)
        if self._use_fused_decode(cache_len):
            h = self._fused_stack(x, pos, cache, cache_len)
            return self._head(h)[:, -1], cache
        x = self._stack(x, pos, cache=cache, cache_len=cache_len)
        return self._logits(x)[:, -1], cache
