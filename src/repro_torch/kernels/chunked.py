"""Chunk-parallel (matmul-form) implementations of the recurrences.

Counterpart of ``repro.kernels.chunked``, with the same chunk algebra:
within a chunk of length C the recurrence is evaluated as dense products,
with an exact state carry between chunks (a Python loop over the chunks
where the reference scans). These are the plain versions of the two
recurrence kernels (``rwkv6_chunk.py``, ``ssd_chunk.py``): the CPU tests
reach them, and ``chip_smoke.py`` holds the kernels against them. The plain
version of the grouped GEMM (``grouped_gemm.py``) is here too: a loop over
the expert groups, the way the chunked forms loop over the chunks.

Derivation (WKV6; cum_i = sum_{l<i} log w_l, so cum_0 = 0):
    intra:  y_i += sum_{j<i} (r_i . (k_j * exp(cum_i - cum_{j+1}))) v_j
    bonus:  y_i += (r_i . (u * k_i)) v_i
    inter:  y_i += (r_i * exp(cum_i)) @ S_prev
    state:  S_new = diag(exp(cum_C)) S_prev
                  + sum_j (k_j * exp(cum_C - cum_{j+1}))^T v_j

Numerical-stability contract: |log w| * chunk_len must stay well under the
fp32 exp overflow (~88). The models clamp log w to [-0.5, -1e-4] and use
chunk_len <= 128, giving a worst-case exponent of 64 — safe in fp32. The
SSD decay is scalar-per-head with the same structure; its exponents are
never positive (decays clipped to [-60, 0]).
"""
from __future__ import annotations

import torch


def _split_chunks(x, chunk: int):
    """(B, S, ...) -> (B, n, C, ...); S must be a multiple of ``chunk``."""
    b, s = x.shape[0], x.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    return x.reshape((b, s // chunk, chunk) + tuple(x.shape[2:]))


def wkv6_chunked(r, k, v, w, u, initial_state=None, chunk: int = 64):
    """Same signature/semantics as ref.wkv6_ref. S must be divisible by
    chunk. Returns (y (B,S,H,dv) fp32, final state (B,H,dk,dv) fp32)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    rc, kc, vc, wc = (_split_chunks(x, chunk) for x in (r, k, v, w))
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                   device=r.device), diagonal=-1)
    ys = []
    for n in range(rc.shape[1]):
        rr, kk, vv, ww = rc[:, n], kc[:, n], vc[:, n], wc[:, n]  # (B,C,H,d)
        logw = torch.log(ww)
        cum = torch.cumsum(logw, dim=1)        # cum_{i+1} = sum_{l<=i}
        cum_in = cum - logw                    # cum_i     = sum_{l<i}
        cum_last = cum[:, -1:]                 # cum_C
        q_dec = rr * torch.exp(cum_in)
        k_dec = kk * torch.exp(-cum)
        k_rem = kk * torch.exp(cum_last - cum)
        scores = torch.einsum("bihk,bjhk->bhij", q_dec, k_dec) * strict
        bonus = torch.einsum("bihk,bihk->bhi", rr, u[None, None] * kk)
        scores = scores + torch.diag_embed(bonus)
        y = torch.einsum("bhij,bjhv->bihv", scores, vv)
        y = y + torch.einsum("bihk,bhkv->bihv", q_dec, state)
        state = torch.exp(cum_last)[:, 0, :, :, None] * state \
            + torch.einsum("bjhk,bjhv->bhkv", k_rem, vv)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def wkv6_decode(r, k, v, w, u, state):
    """Single-token step: r,k,v,w: (B,1,H,d); state: (B,H,dk,dv). The
    plain form of ``ops.wkv6_decode`` (``wkv6_decode.py``), which runs it on
    the CPU and with ``attn_impl="plain"``; on the card the model's decode
    step runs the kernel ``csrc/wkv6_decode.cu`` instead, which chip_smoke.py
    holds against this form."""
    rt, kt, vt, wt = (x[:, 0].float() for x in (r, k, v, w))
    state = state.float()
    kv = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rt,
                     state + u.float()[None, :, :, None] * kv)
    return y[:, None], wt[..., :, None] * state + kv


def ssd_chunked(x, dt, A, B, C, D, initial_state=None, chunk: int = 64):
    """Mamba-2 SSD, chunked matmul form. Same semantics as ref.ssd_ref.
    Returns (y (b,S,H,P) fp32, final state (b,H,P,N) fp32)."""
    b, s, h, p = x.shape
    n_state = B.shape[-1]
    x, dt, A, B, C, D = (t.float() for t in (x, dt, A, B, C, D))
    state = (torch.zeros((b, h, p, n_state), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    xc, dtc, Bc, Cc = (_split_chunks(t, chunk) for t in (x, dt, B, C))
    incl = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=x.device))          # j <= i
    ys = []
    for n in range(xc.shape[1]):
        xx, dd, BB, CC = xc[:, n], dtc[:, n], Bc[:, n], Cc[:, n]
        la = dd * A[None, None, :]             # log a_t  (b,C,H)
        cum = torch.cumsum(la, dim=1)          # cum_i = sum_{l<=i} log a_l
        cum_last = cum[:, -1:]
        xdt = xx * dd[..., None]               # dt_j x_j
        decay = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                      -60.0, 0.0))          # (b,i,j,H)
        scores = torch.einsum("bihn,bjhn->bijh", CC, BB) * decay \
            * incl[None, :, :, None]
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        q_dec = CC * torch.exp(cum)[..., None]
        y = y + torch.einsum("bihn,bhpn->bihp", q_dec, state)
        y = y + D[None, None, :, None] * xx
        k_rem = BB * torch.exp(cum_last - cum)[..., None]
        state = torch.exp(cum_last)[:, 0, :, None, None] * state \
            + torch.einsum("bjhp,bjhn->bhpn", xdt, k_rem)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_decode(x, dt, A, B, C, D, state):
    """Single-token SSD step. x: (b,1,H,P); state: (b,H,P,N)."""
    xt, dtt, Bt, Ct = (t[:, 0].float() for t in (x, dt, B, C))
    a = torch.exp(dtt * A.float()[None, :])
    upd = (dtt[..., None] * xt)[..., :, None] * Bt[..., None, :]
    h_new = a[..., None, None] * state.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ct) \
        + D.float()[None, :, None] * xt
    return y[:, None], h_new


def grouped_matmul_loop(x, w, group_sizes):
    """``lax.ragged_dot`` as a loop of ``torch.matmul`` over the contiguous
    groups of the rows: x (C, K), w (E, K, N), group_sizes (E,) -> (C, N)
    in x's dtype, rows past the last group 0. Reads ``group_sizes`` on the
    host (a synchronisation on the card)."""
    C = x.shape[0]
    out = torch.zeros((C, w.shape[-1]), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):          # host sync
        n = min(n, C - start)
        if n <= 0:
            continue
        out[start:start + n] = torch.matmul(x[start:start + n], w[e])
        start += n
    return out
