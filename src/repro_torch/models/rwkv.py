"""RWKV6 (Finch) — attention-free LM with data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv.RWKV6Model``: token-shift mixing, the
time-mix block with the WKV6 recurrence (the chunked kernel ``ops.wkv6``
for ``forward``, the O(1)-state step ``wkv6_decode`` for ``decode_step``),
squared-ReLU channel-mix, the dynamic decay LoRA with the per-token
log-decay clamped to [-0.5, -1e-4] (``kernels/chunked.py`` stability
contract), ``layer_norm`` as the reference's group-norm approximation, and
an untied ``lm_head``. Differences that come with PyTorch's idiom, as for
``DecoderLM``:

  * an ``nn.Module`` that owns its parameters under the reference tree's
    keys, layers stacked on a leading ``L`` axis (``layers.{ln1, w_r, ...}``);
  * a Python loop over ``L`` where the reference scans; no remat, no
    sharding; ``loss_fn`` trains through the plain WKV6 form
    (``attn_impl="plain"``: the kernel has no backward); serving calls it
    under ``torch.inference_mode()``;
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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.chunked import wkv6_decode
from repro_torch.models import layers as L
from repro_torch.models.api import RunConfig

LORA_R = 64
LOGW_MIN, LOGW_MAX = -0.5, -1e-4


class RWKV6Model(nn.Module):
    def __init__(self, cfg: ArchConfig, run_cfg: Optional[RunConfig] = None,
                 device: DeviceLike = None):
        """Parameters are allocated uninitialised on ``device`` (``None`` =
        the GPU; ``"meta"`` gives a storage-free skeleton); fill them with
        ``init_params`` or ``load_state_dict``."""
        super().__init__()
        if cfg.d_model % cfg.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        self.cfg = cfg
        self.run = run_cfg or RunConfig()
        self.head_dim = cfg.d_model // cfg.n_heads
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        dt, f32, d = torch_dtype(cfg.dtype), torch.float32, cfg.d_model

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.embed = param((cfg.vocab, d), dt)
        self.ln_in, self.ln_inb = param((d,), f32), param((d,), f32)
        self.final_norm = param((d,), f32)
        self.final_normb = param((d,), f32)
        self.lm_head = param((d, cfg.vocab), dt)
        self.layers = nn.ParameterDict({
            k: param((cfg.n_layers,) + shape, dtype)
            for k, (shape, dtype) in self._layer_shapes().items()})

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

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "RWKV6Model":
        """Fill the parameters in place from ``generator`` with the
        reference's scales: norm weights 1 and biases 0, every ``mu_*`` 0.5,
        ``decay_base`` -2, ``bonus_u`` N(0, 0.3), the embedding N(0, 0.02),
        every other matrix N(0, 1/sqrt(fan_in)) with ``fan_in`` read off the
        stacked shape (``L`` for the layer matrices, as in the reference)."""
        for k, p in self.layers.items():
            if k.startswith(("ln", "gn")):
                p.fill_(0.0 if k.endswith("b") else 1.0)
            elif k.startswith("mu_"):
                p.fill_(0.5)
            elif k == "decay_base":
                p.fill_(-2.0)
            elif k == "bonus_u":
                p.copy_(L.dense_init(generator, p.shape, p.dtype, scale=0.3,
                                     device=p.device))
            else:
                p.copy_(L.dense_init(generator, p.shape, p.dtype,
                                     device=p.device))
        self.embed.copy_(L.dense_init(generator, self.embed.shape,
                                      self.embed.dtype, scale=0.02,
                                      device=self.device))
        for p in (self.ln_in, self.final_norm):
            p.fill_(1.0)
        for p in (self.ln_inb, self.final_normb):
            p.zero_()
        self.lm_head.copy_(L.dense_init(generator, self.lm_head.shape,
                                        self.lm_head.dtype,
                                        device=self.device))
        return self

    def init_cache(self, shape: ShapeSpec,
                   batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed decode state; its size does not depend on the sequence
        length."""
        cfg = self.cfg
        b = batch or shape.global_batch
        h, hd = cfg.n_heads, self.head_dim
        z = dict(dtype=torch.float32, device=self.device)
        return {"wkv": torch.zeros((cfg.n_layers, b, h, hd, hd), **z),
                "shift_att": torch.zeros((cfg.n_layers, b, cfg.d_model), **z),
                "shift_ffn": torch.zeros((cfg.n_layers, b, cfg.d_model), **z)}

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
        logw = w["decay_base"][None, None, :] + torch.matmul(
            torch.tanh(torch.matmul(xw.float(), w["decay_A"].float())),
            w["decay_B"].float())
        return torch.clamp(-torch.exp(logw), LOGW_MIN, LOGW_MAX)

    def _time_mix(self, w, x, prev_shift, wkv_state, decode: bool):
        cfg, run = self.cfg, self.run
        b, s, d = x.shape
        h, hd = cfg.n_heads, self.head_dim
        xs = self._shifted(x, prev_shift, decode)
        xf = x.float()
        dt = torch_dtype(cfg.dtype)
        xr, xk, xv, xg, xw = ((xf + (xs - xf) * w[f"mu_{n}"]).to(dt)
                              for n in ("r", "k", "v", "g", "w"))
        r = torch.matmul(xr, w["w_r"]).reshape(b, s, h, hd)
        k = torch.matmul(xk, w["w_k"]).reshape(b, s, h, hd)
        v = torch.matmul(xv, w["w_v"]).reshape(b, s, h, hd)
        g = F.silu(torch.matmul(xg, w["w_g"]).float())
        decay = torch.exp(self._decay(w, xw).reshape(b, s, h, hd))
        if decode:
            y, new_state = wkv6_decode(r, k, v, decay, w["bonus_u"],
                                       wkv_state)
        else:
            y, new_state = ops.wkv6(r, k, v, decay, w["bonus_u"], wkv_state,
                                    chunk=run.seq_chunk, impl=run.attn_impl)
        y = L.layer_norm(y.reshape(b, s, d), w["gn"], w["gnb"])
        y = torch.matmul((y * g).to(dt), w["w_o"])
        return y, new_state, xf[:, -1, :]

    def _channel_mix(self, w, x, prev_shift, decode: bool):
        dt = torch_dtype(self.cfg.dtype)
        xs = self._shifted(x, prev_shift, decode)
        xf = x.float()
        xk = (xf + (xs - xf) * w["mu_ck"]).to(dt)
        xr = (xf + (xs - xf) * w["mu_cr"]).to(dt)
        kk = torch.square(torch.relu(torch.matmul(xk, w["c_k"])))
        out = torch.matmul(kk, w["c_v"])
        rr = torch.sigmoid(torch.matmul(xr, w["c_r"]).float())
        return (out.float() * rr).to(x.dtype), xf[:, -1, :]

    def _block(self, w, x, state, decode: bool):
        wkv, sh_a, sh_f = state
        h = L.layer_norm(x, w["ln1"], w["ln1b"])
        o, wkv_new, sh_a_new = self._time_mix(w, h, sh_a, wkv, decode)
        x = x + o
        h = L.layer_norm(x, w["ln2"], w["ln2b"])
        o, sh_f_new = self._channel_mix(w, h, sh_f, decode)
        return x + o, (wkv_new, sh_a_new, sh_f_new)

    def _embed(self, tokens):
        x = self.embed[tokens.long()]
        return L.layer_norm(x, self.ln_in, self.ln_inb)

    def _logits(self, x):
        x = L.layer_norm(x, self.final_norm, self.final_normb)
        return torch.matmul(x, self.lm_head)

    # ------------------------------------------------------------------ steps
    def forward(self, batch) -> torch.Tensor:
        """Prefill forward from zero state: batch = {tokens (B,S)} -> logits
        (B, S, V). S must be a multiple of ``run.seq_chunk``."""
        tokens = batch["tokens"].to(self.device)
        x = self._embed(tokens)
        b = x.shape[0]
        h, hd, d = self.cfg.n_heads, self.head_dim, self.cfg.d_model
        z = dict(dtype=torch.float32, device=self.device)
        state = (torch.zeros((b, h, hd, hd), **z), torch.zeros((b, d), **z),
                 torch.zeros((b, d), **z))
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            x, _ = self._block(w, x, state, decode=False)
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
        # in, so no branch depends on the lengths
        keep = (cache_len > 0).to(torch.float32).reshape(-1).expand(b)
        x = self._embed(tokens)
        for i in range(self.cfg.n_layers):
            w = {k: p[i] for k, p in self.layers.items()}
            state = (cache["wkv"][i] * keep[:, None, None, None],
                     cache["shift_att"][i] * keep[:, None],
                     cache["shift_ffn"][i] * keep[:, None])
            x, (wkv, sh_a, sh_f) = self._block(w, x, state, decode=True)
            cache["wkv"][i].copy_(wkv)
            cache["shift_att"][i].copy_(sh_a)
            cache["shift_ffn"][i].copy_(sh_f)
        return self._logits(x)[:, -1], cache
