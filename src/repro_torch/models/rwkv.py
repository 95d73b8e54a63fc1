"""RWKV6 (Finch) — attention-free LM with data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv.RWKV6Model``: token-shift mixing, the
time-mix block with the WKV6 recurrence (the chunked kernel ``ops.wkv6``
for ``forward``, the O(1)-state step ``ops.wkv6_decode`` for
``decode_step``: on the card the kernel ``csrc/wkv6_decode.cu``, which
reads and writes each slot's state once in place in the cache; on the CPU
and with ``attn_impl="plain"`` ``chunked.wkv6_decode``),
squared-ReLU channel-mix, the dynamic decay LoRA with the per-token
log-decay clamped to [-0.5, -1e-4] (``kernels/chunked.py`` stability
contract), ``layer_norm`` as the reference's group-norm approximation, and
an untied ``lm_head``. Differences that come with PyTorch's idiom, as for
``DecoderLM``:

  * an ``nn.Module`` that owns its parameters under the reference tree's
    keys, layers stacked on a leading ``L`` axis (``layers.{ln1, w_r, ...}``);
  * a Python loop over ``L`` where the reference scans; with
    ``RunConfig.remat`` each block of ``forward`` is checkpointed while
    gradients are recorded (``models/remat.py``), as the reference's
    ``jax.checkpoint``; ``loss_fn`` trains through the plain WKV6 form (``attn_impl="plain"``:
    the kernel has no backward); serving calls it under
    ``torch.inference_mode()``;
  * ``decode_step`` writes the state into the cache in place and returns
    the cache it was given.

One deliberate difference in behaviour: ``decode_step`` takes ``cache_len``
as a scalar or one length per row and **starts a row whose length is 0 from
zero state** (its ``wkv``, ``shift_att`` and ``shift_ffn`` rows are
zeroed). The reference ignores ``cache_len``, so under continuous batching a
request admitted into a reused or idle slot inherits the state its slot was
left in; here a slot's answer does not depend on its neighbours (ROADMAP
§C). On a fresh cache at length 0 — every input of the reference's own tests
— both give the same numbers.

Decode state per layer: wkv (B, H, dk, dv), shift_att (B, D), shift_ffn
(B, D), all fp32 — O(1) in context length.

**On a mesh** (built inside ``sharding.use_mesh(mesh)``) every parameter
is this rank's shard of ``param_pspecs()`` and, with a model axis of ``n``
ranks, the blocks run the tensor-parallel arithmetic GSPMD derives from
those specs, the collectives written out (each carries its gradient):

  * time-mix: ``w_r``/``w_k``/``w_v``/``w_g`` and ``decay_B`` are split by
    columns and ``bonus_u`` by heads, so the rank holds heads ``[r·H/n,
    (r+1)·H/n)`` and WKV6 (K3 in ``forward``, ``ops.wkv6_decode`` in
    ``decode_step``) runs at those heads on this rank's slice of the wkv
    state (``cache_pspecs``); ``w_o`` is split by rows, then ``psum``;
  * the group-norm approximation is a ``layer_norm`` over all D channels,
    which here span the ranks. Each rank takes its channels' mean and sum
    of squared deviations, gathers the ranks' pairs (one collective of
    ``2·B·S`` values where gathering ``y`` moves ``B·S·D``) and combines
    them exactly (Chan's parallel variance: the sum of the pairs' squared
    deviations plus the spread of their means, with no ``E[y²] − E[y]²``
    cancellation), so the statistics are the reference's up to round-off;
  * channel-mix: ``c_k`` by columns and ``c_v`` by rows, so ``kk @ c_v``
    is a partial sum completed by ``psum``; ``sigmoid(x @ c_r)`` is this
    rank's columns, gathered (``all_gather``) so that the product is taken
    replicated, as the reference's;
  * the embedding is split over the vocabulary (a masked local lookup,
    then ``psum``) and ``lm_head`` by columns (the logits gathered), as in
    ``DecoderLM``; token shifts and their state are replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import remat
from repro_torch.models import sharding as S
from repro_torch.models.api import RunConfig
from repro_torch.models.sharding import P

LORA_R = 64
LOGW_MIN, LOGW_MAX = -0.5, -1e-4


class RWKV6Model(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``. Built inside
        ``sharding.use_mesh(mesh)``, every parameter is this rank's shard."""
        super().__init__()
        if cfg.d_model % cfg.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.head_dim = cfg.d_model // cfg.n_heads
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

        for name in ("embed", "ln_in", "ln_inb", "final_norm",
                     "final_normb", "lm_head"):
            setattr(self, name, param(name))
        self.layers = nn.ParameterDict({
            k: param(f"layers.{k}") for k in self._layer_shapes()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ params
    def _layer_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        dt, f32 = torch_dtype(cfg.dtype), torch.float32
        return {
            "ln1": ((d,), f32), "ln1b": ((d,), f32),
            "ln2": ((d,), f32), "ln2b": ((d,), f32),
            # time-mix
            "mu_r": ((d,), f32), "mu_k": ((d,), f32), "mu_v": ((d,), f32),
            "mu_g": ((d,), f32), "mu_w": ((d,), f32),
            "w_r": ((d, d), dt), "w_k": ((d, d), dt), "w_v": ((d, d), dt),
            "w_g": ((d, d), dt), "w_o": ((d, d), dt),
            "decay_base": ((d,), f32),
            "decay_A": ((d, LORA_R), dt), "decay_B": ((LORA_R, d), dt),
            "bonus_u": ((cfg.n_heads, self.head_dim), f32),
            "gn": ((d,), f32), "gnb": ((d,), f32),
            # channel-mix
            "mu_ck": ((d,), f32), "mu_cr": ((d,), f32),
            "c_k": ((d, f), dt), "c_v": ((f, d), dt), "c_r": ((d, d), dt),
        }

    def param_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every parameter, by ``state_dict``
        name (the reference's ``param_specs``)."""
        cfg = self.cfg
        dt, f32, d = torch_dtype(cfg.dtype), torch.float32, cfg.d_model
        out = {"embed": ((cfg.vocab, d), dt), "ln_in": ((d,), f32),
               "ln_inb": ((d,), f32), "final_norm": ((d,), f32),
               "final_normb": ((d,), f32), "lm_head": ((d, cfg.vocab), dt)}
        out.update({f"layers.{k}": ((cfg.n_layers,) + shape, dtype)
                    for k, (shape, dtype) in self._layer_shapes().items()})
        return out

    def param_pspecs(self) -> Dict[str, P]:
        """The reference's ``param_pspecs``, keyed by ``state_dict``
        name."""
        m = self.run.model_axis
        layers = {}
        for k, (shape, _) in self._layer_shapes().items():
            if len(shape) == 1:
                layers[k] = P(None, None)
            elif k in ("w_r", "w_k", "w_v", "w_g", "c_k", "c_r"):
                layers[k] = P(None, None, m)     # column-parallel
            elif k in ("w_o", "c_v"):
                layers[k] = P(None, m, None)     # row-parallel
            elif k == "decay_A":
                layers[k] = P(None, None, None)
            elif k == "decay_B":
                layers[k] = P(None, None, m)
            elif k == "bonus_u":
                layers[k] = P(None, m, None)
            else:
                layers[k] = P(*((None,) * (len(shape) + 1)))
        out = {"embed": P(m, None), "ln_in": P(None), "ln_inb": P(None),
               "final_norm": P(None), "final_normb": P(None),
               "lm_head": P(None, m)}
        out.update({f"layers.{k}": v for k, v in layers.items()})
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
        return {"wkv": P(None, dax, m, None, None),
                "shift_att": P(None, dax, None),
                "shift_ffn": P(None, dax, None)}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "RWKV6Model":
        """Fill the parameters in place from ``generator`` with the
        reference's scales: norm weights 1 and biases 0, every ``mu_*`` 0.5,
        ``decay_base`` -2, ``bonus_u`` N(0, 0.3), the embedding N(0, 0.02),
        every other matrix N(0, 1/sqrt(fan_in)) with ``fan_in`` read off the
        stacked shape (``L`` for the layer matrices, as in the reference).
        On a mesh every rank makes the single-device draw and keeps its
        slice."""
        specs = self.param_pspecs()

        def draw(p, name, scale=None):
            full = self._full[name][0]
            t = L.dense_init(generator, full, p.dtype, scale=scale,
                             device=p.device)
            p.copy_(S.keep_local(t, specs[name], self.mesh, name))

        for k, p in self.layers.items():
            if k.startswith(("ln", "gn")):
                p.fill_(0.0 if k.endswith("b") else 1.0)
            elif k.startswith("mu_"):
                p.fill_(0.5)
            elif k == "decay_base":
                p.fill_(-2.0)
            else:
                draw(p, f"layers.{k}", 0.3 if k == "bonus_u" else None)
        draw(self.embed, "embed", 0.02)
        for p in (self.ln_in, self.final_norm):
            p.fill_(1.0)
        for p in (self.ln_inb, self.final_normb):
            p.zero_()
        draw(self.lm_head, "lm_head")
        return self

    def cache_shapes(self, shape: ShapeSpec, batch: Optional[int] = None
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """Global shape and dtype of every cache tensor; the decode state's
        size does not depend on the sequence length."""
        cfg, f32 = self.cfg, torch.float32
        b = batch or shape.global_batch
        h, hd = cfg.n_heads, self.head_dim
        return {"wkv": ((cfg.n_layers, b, h, hd, hd), f32),
                "shift_att": ((cfg.n_layers, b, cfg.d_model), f32),
                "shift_ffn": ((cfg.n_layers, b, cfg.d_model), f32)}

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed decode state. On a mesh this rank's part of
        ``cache_pspecs`` (``batch`` is then the global batch)."""
        b = batch or shape.global_batch
        specs = None if self.mesh is None else self.cache_pspecs(
            ShapeSpec(shape.name, shape.seq_len, b, "decode"))
        return S.local_zeros(self.cache_shapes(shape, b), specs, self.mesh,
                             self.device)

    # ------------------------------------------------------------------ blocks
    @staticmethod
    def _shifted(x, prev, decode: bool):
        """Token shift: x_{t-1} with ``prev`` feeding position 0 (decode: the
        previous token, broadcast over the one position). fp32, as the
        reference's promotion of the fp32 state gives."""
        if decode:
            return prev[:, None, :].expand(x.shape).float()
        return torch.cat([prev[:, None, :].float(), x[:, :-1, :].float()],
                         dim=1)

    def _decay(self, w, xw):
        # the LoRA's first half is replicated, its second (decay_B) this
        # rank's columns
        lora = S.copy_to(torch.tanh(torch.matmul(xw.float(),
                                                 w["decay_A"].float())),
                         self.run.model_axis, self.mesh)
        logw = self._cols(w["decay_base"])[None, None, :] + torch.matmul(
            lora, w["decay_B"].float())
        return torch.clamp(-torch.exp(logw), LOGW_MIN, LOGW_MAX)

    def _cols(self, t):
        """This rank's channels of a replicated (D,) vector that per-rank
        compute reads (its gradient is summed over the model axis)."""
        if self.n_model == 1:
            return t
        dl = t.shape[-1] // self.n_model
        i = self.mesh.index(self.run.model_axis)
        return S.copy_to(t, self.run.model_axis, self.mesh)[
            ..., i * dl:(i + 1) * dl]

    def _group_norm(self, y, w):
        """``layer_norm`` over all D channels of ``y`` (B, S, D/n), this
        rank's channels (the module docstring says how)."""
        if self.n_model == 1:
            return L.layer_norm(y, w["gn"], w["gnb"])
        n, eps = self.n_model, 1e-5
        yf = y.float()
        mean = yf.mean(-1, keepdim=True)
        m2 = torch.square(yf - mean).sum(-1, keepdim=True)
        pairs = S.all_gather_rs(torch.cat([mean, m2], -1),
                                self.run.model_axis, -1, self.mesh)
        pairs = pairs.reshape(pairs.shape[:-1] + (n, 2))
        means, m2s = pairs[..., 0], pairs[..., 1]
        mu = means.mean(-1, keepdim=True)
        var = (m2s.sum(-1, keepdim=True) + y.shape[-1] * torch.square(
            means - mu).sum(-1, keepdim=True)) / (y.shape[-1] * n)
        out = (yf - mu) * torch.rsqrt(var + eps)
        return (out * self._cols(w["gn"]) + self._cols(w["gnb"])).to(y.dtype)

    def _time_mix(self, w, x, prev_shift, wkv_state, cache_len):
        cfg, run, mesh, m = self.cfg, self.run, self.mesh, self.run.model_axis
        b, s, d = x.shape
        h, hd = cfg.n_heads // self.n_model, self.head_dim
        decode = cache_len is not None
        xs = self._shifted(x, prev_shift, decode)
        xf = x.float()
        dt = torch_dtype(cfg.dtype)
        # the mixes are replicated; each enters this rank's columns
        xr, xk, xv, xg = (S.copy_to((xf + (xs - xf) * w[f"mu_{n}"]).to(dt),
                                    m, mesh) for n in ("r", "k", "v", "g"))
        xw = (xf + (xs - xf) * w["mu_w"]).to(dt)
        r = torch.matmul(xr, w["w_r"]).reshape(b, s, h, hd)
        k = torch.matmul(xk, w["w_k"]).reshape(b, s, h, hd)
        v = torch.matmul(xv, w["w_v"]).reshape(b, s, h, hd)
        g = F.silu(torch.matmul(xg, w["w_g"]).float())
        decay = torch.exp(self._decay(w, xw).reshape(b, s, h, hd))
        if decode:
            # the cache's slice is read and written in place
            y = ops.wkv6_decode(r, k, v, decay, w["bonus_u"], wkv_state,
                                cache_len, impl=run.attn_impl)
            new_state = wkv_state
        else:
            y, new_state = ops.wkv6(r, k, v, decay, w["bonus_u"], wkv_state,
                                    chunk=run.seq_chunk, impl=run.attn_impl)
        y = self._group_norm(y.reshape(b, s, h * hd), w)
        y = S.psum_matmul((y * g).to(dt), w["w_o"], m, mesh)
        return y, new_state, xf[:, -1, :]

    def _channel_mix(self, w, x, prev_shift, decode: bool):
        dt = torch_dtype(self.cfg.dtype)
        mesh, m = self.mesh, self.run.model_axis
        xs = self._shifted(x, prev_shift, decode)
        xf = x.float()
        xk = S.copy_to((xf + (xs - xf) * w["mu_ck"]).to(dt), m, mesh)
        xr = S.copy_to((xf + (xs - xf) * w["mu_cr"]).to(dt), m, mesh)
        kk = torch.square(torch.relu(torch.matmul(xk, w["c_k"])))
        out = S.psum_matmul(kk, w["c_v"], m, mesh)
        rr = S.all_gather(torch.sigmoid(torch.matmul(xr, w["c_r"]).float()),
                          m, -1, mesh)
        return (out.float() * rr).to(x.dtype), xf[:, -1, :]

    def _block(self, w, x, state, cache_len=None):
        """One layer; ``cache_len`` given (decode), ``state``'s wkv is the
        cache's slice, written in place."""
        decode = cache_len is not None
        wkv, sh_a, sh_f = state
        h = L.layer_norm(x, w["ln1"], w["ln1b"])
        o, wkv_new, sh_a_new = self._time_mix(w, h, sh_a, wkv, cache_len)
        x = x + o
        h = L.layer_norm(x, w["ln2"], w["ln2b"])
        o, sh_f_new = self._channel_mix(w, h, sh_f, decode)
        return x + o, (wkv_new, sh_a_new, sh_f_new)

    def _embed(self, tokens):
        x = S.vocab_lookup(self.embed, tokens, self.run.model_axis, self.mesh)
        return L.layer_norm(x, self.ln_in, self.ln_inb)

    def _logits(self, x):
        x = L.layer_norm(x, self.final_norm, self.final_normb)
        return S.vocab_logits(x, self.lm_head, self.run.model_axis, self.mesh)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward from zero state: batch = {tokens (B,S)} -> logits
        (B, S, V). S must be a multiple of ``run.seq_chunk``."""
        tokens = batch["tokens"].to(self.device)
        x = self._embed(tokens)
        b = x.shape[0]
        h, hd, d = self.cfg.n_heads // self.n_model, self.head_dim, \
            self.cfg.d_model
        z = dict(dtype=torch.float32, device=self.device)
        state = (torch.zeros((b, h, hd, hd), **z), torch.zeros((b, d), **z),
                 torch.zeros((b, d), **z))

        def block(x, w):
            return self._block(w, x, state)[0]

        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            x = remat.layer(self.run, block, x, w)
        return self._logits(x)

    def loss_fn(self, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``forward`` against
        ``batch["labels"]`` (B, S)."""
        return L.next_token_loss(self.forward(batch), batch["labels"])

    def decode_step(self, cache, batch):
        """One decode step: batch = {tokens (B,1), cache_len () or (B,)} ->
        (logits (B, V), cache). ``cache`` is written in place; a row whose
        ``cache_len`` is 0 starts from zero state."""
        tokens = batch["tokens"].to(self.device)
        cache_len = torch.as_tensor(batch["cache_len"], device=self.device)
        b = tokens.shape[0]
        # 1 for a row that continues, 0 for a row that starts: multiplied
        # in, so no branch depends on the lengths (``ops.wkv6_decode``
        # applies the same rule to the wkv state it updates in place)
        keep = (cache_len > 0).to(torch.float32).reshape(-1).expand(b)
        x = self._embed(tokens)
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            state = (cache["wkv"][i], cache["shift_att"][i] * keep[:, None],
                     cache["shift_ffn"][i] * keep[:, None])
            x, (_, sh_a, sh_f) = self._block(w, x, state, cache_len)
            cache["shift_att"][i].copy_(sh_a)
            cache["shift_ffn"][i].copy_(sh_f)
        return self._logits(x)[:, -1], cache
