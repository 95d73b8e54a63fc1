"""The one traffic generator: a mix's parameters and a seed in, rounds of
requests out.

A mix (``traffic/<name>.json``) gives the lengths of prompts and outputs as
clipped lognormals and the ``fanout`` of a round: one client sends a round
of ``fanout`` requests at once, and its next round when every request of
the last is done. Every round, under every seed, holds the same work: its
prompt lengths are the prompt distribution's quantiles at the ``fanout``
midpoints ``(j + 0.5) / fanout``, its output lengths the output
distribution's at the same points, paired with the prompts by one fixed
permutation, and sent in an order that changes from round to round but
not with the seed. Which requests share the batcher's steps follows from
that order, so every seed meets the same schedule. The seed sets the
token ids (uniform over the vocabulary), which the served tokens and the
comparison of ``harness/check.py`` follow.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

PAIRING_SEED = 0          # the fixed permutation pairing prompts and outputs
ORDER_SEED = 1            # the rounds' orders, the same for every seed


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def lognormal_quantile(dist: dict, p: float) -> int:
    """The clipped lognormal ``dist`` (``median``, ``sigma``, ``min``,
    ``max``) at probability ``p``, rounded to whole tokens."""
    x = round(dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(
        min(max(p, 1e-9), 1.0 - 1e-9))))
    return int(min(max(x, dist["min"]), dist["max"]))


def round_lengths(mix: dict) -> List[Tuple[int, int]]:
    """The (prompt, output) lengths every round holds."""
    n = mix["fanout"]
    ps = [(j + 0.5) / n for j in range(n)]
    pair = np.random.default_rng(PAIRING_SEED).permutation(n)
    return [(lognormal_quantile(mix["prompt_len"], ps[j]),
             lognormal_quantile(mix["output_len"], ps[pair[j]]))
            for j in range(n)]


class Requests:
    """The rounds in turn: each request's prompt token ids (the seed's) and
    the number of tokens to generate."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.lengths = round_lengths(mix)
        self.order = np.random.default_rng(ORDER_SEED)
        self.ids = seed_rng(seed, 2)
        self.vocab = vocab

    def round(self) -> List[Tuple[List[int], int]]:
        out = []
        for j in self.order.permutation(len(self.lengths)):
            p, n = self.lengths[j]
            out.append(([int(t) for t in self.ids.integers(0, self.vocab, p)],
                        n))
        return out
