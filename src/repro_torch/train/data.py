"""Deterministic synthetic data.

Counterpart of ``repro.train.data``:

  * ``ZipfLMStream`` — a learnable synthetic language (a Zipf unigram
    distribution with a fixed successor for each token, followed 70 % of
    the time). The same numpy code as the reference, so its tokens equal
    the reference's bit for bit; returned as int32 tensors on ``device``.
  * ``random_tokens`` — uniform tokens drawn from a ``torch.Generator``
    seeded from (``seed``, ``step``). It cannot give ``jax.random``'s bits;
    what it shares with the reference is its properties (range, shape,
    labels shifted by one, determinism in the step).

Both are step-indexed: ``batch(step)`` is a pure function of the step, so a
restarted job resumes with the same data order. ``device=None`` means the
GPU, as for every entry point of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.train.compress import leaf_seed


def random_tokens(step: int, batch: int, seq: int, vocab: int,
                  seed: int = 0, device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(leaf_seed(seed, step))
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=g, device=dev,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class ZipfLMStream:
    vocab: int
    seq: int
    batch: int
    seed: int = 0
    alpha: float = 1.2
    device: DeviceLike = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self.unigram = ranks ** (-self.alpha)
        self.unigram /= self.unigram.sum()
        self.succ = rng.integers(0, self.vocab, size=self.vocab)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        cur = rng.choice(self.vocab, size=self.batch, p=self.unigram)
        toks[:, 0] = cur
        for t in range(1, self.seq + 1):
            follow = rng.random(self.batch) < 0.7
            nxt = np.where(
                follow, self.succ[toks[:, t - 1]],
                rng.choice(self.vocab, size=self.batch, p=self.unigram))
            toks[:, t] = nxt
        dev = resolve_device(self.device)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
