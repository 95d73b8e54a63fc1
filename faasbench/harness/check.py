"""The comparison that decides ``correct``.

Once the window has closed and the program's replicas are freed:

* the orchestrator: every invocation sent by the window's end (those in
  flight when it opened too) is done exactly once and did not fail (one
  that never came is missing);
* each done invocation carries as many tokens as it asked for, each in the
  vocabulary;
* the served tokens: a sample of twelve done invocations, drawn from the
  seed with the longest among them, is run through the plain float32 reference
  (``reference/<family>.py``) on the weights of the sandbox that served it,
  each request alone, its prompt followed by its served tokens. At each
  served token the gap by which its reference logit lies below the
  reference's best, over the standard deviation of that position's
  reference logits, is read. The mean gap over the sample and the largest
  of the requests' own mean gaps are compared with the configuration's
  limits ``mean_gap`` and ``worst_request_gap`` (the widest gap is printed
  beside them): the first sees every request a little wrong, the second
  one request, or a part of the batch, wrong. Greedy decoding makes a
  served token the program's best, so gaps beyond the program's rounding
  show tokens computed wrongly, or slots that read another's state.

With ``control`` the same numbers are read for the tokens that the
reference computed in a lower precision (fp8, or the bf16 witness) puts
first at the same positions.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List

import torch

from harness import traffic as T

SAMPLED = 12              # requests sampled (all done ones, where fewer)


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: no TF32 on the tensor cores."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def orchestrator(rec) -> Dict[str, int]:
    """Counts of the invocations sent by the window's end: missing (failed,
    or not done by the drain's end), done more than once, and done with the
    wrong tokens."""
    vocab = rec.spec["vocab_size"]
    missing = sum(1 for i in rec.sent if rec.missing(i))
    twice = sum(1 for i in rec.sent if rec.done_count.get(i.inv_id, 0) > 1)
    bad = 0
    for i in rec.sent:
        if rec.missing(i):
            continue
        toks = i.request.tokens or []
        if len(toks) != i.max_new or not all(0 <= t < vocab for t in toks):
            bad += 1
    return {"missing": missing, "done_twice": twice, "bad_tokens": bad}


def sample(rec, seed: int) -> list:
    """The longest done invocation, then others in the seed's order, to
    ``SAMPLED`` requests: enough that slots all over the batch are in it,
    never the longest request alone."""
    done = [i for i in rec.sent if not rec.missing(i) and i.request.tokens]
    if not done:
        return []
    size = [len(i.request.prompt) + len(i.request.tokens) for i in done]
    first = max(range(len(done)), key=lambda j: (size[j], -j))
    out = [done[first]]
    for j in T.seed_rng(seed, 4).permutation(len(done)):
        if len(out) >= SAMPLED:
            break
        if j != first:
            out.append(done[j])
    return out


def _gaps(ref_logits, seq_tokens, n_prompt, chosen=None) -> List[float]:
    """Normalised gaps at the served positions: the logits at position p
    predict token p + 1. ``chosen`` (per served position) replaces the
    served token by another pick (the control's)."""
    z = ref_logits[n_prompt - 1:-1]
    served = seq_tokens[n_prompt:]
    pick = served if chosen is None else chosen
    best = z.max(dim=-1).values
    got = z.gather(1, pick[:, None])[:, 0]
    return ((best - got) / z.std(dim=-1)).tolist()


def _by_sandbox(rec, invs):
    groups = defaultdict(list)
    for inv in invs:
        groups[rec.sandbox_of[id(inv.request)]].append(inv)
    return groups


def served_gap(rec, ref, seed: int, device, control: str = "") -> dict:
    """The normalised gaps of the served tokens of ``sample`` (or, with
    ``control`` a precision, of that precision's picks), with the counts."""
    invs = sample(rec, seed)
    gaps = []
    with exact_float32():
        for sid, group in sorted(_by_sandbox(rec, invs).items()):
            w = ref.draw_weights(rec.spec, sid, device)
            seqs = [torch.tensor(list(i.request.prompt) + list(
                i.request.tokens), device=device) for i in group]
            zs = ref.logits(rec.spec, w, seqs)
            zc = ref.logits(rec.spec, w, seqs, control) if control \
                else None
            for j, (inv, seq) in enumerate(zip(group, seqs)):
                n_p = len(inv.request.prompt)
                chosen = None
                if control:
                    chosen = zc[j][n_p - 1:-1].argmax(dim=-1)
                gaps.append(_gaps(zs[j], seq, n_p, chosen))
            del w, zs, zc
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return dict(gap_stats(gaps), requests=len(invs),
                tokens=sum(len(r) for r in gaps))


def gap_stats(gaps: List[List[float]]) -> dict:
    """Of the gaps, request by request: the widest gap, the mean gap, the
    largest of the requests' own mean gaps, and the share of tokens that
    are not the reference's best (gap above 0)."""
    flat = [g for req in gaps for g in req]
    if not flat:
        return {"max_gap": 0.0, "mean_gap": 0.0, "worst_request_gap": 0.0,
                "off_best": 0.0}
    return {"max_gap": max(flat), "mean_gap": sum(flat) / len(flat),
            "worst_request_gap": max(sum(r) / len(r) for r in gaps if r),
            "off_best": sum(1 for g in flat if g > 0) / len(flat)}
