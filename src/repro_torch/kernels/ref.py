"""Oracles for every kernel of the port: the attention oracles delegate to
the single sources; the recurrences are written out token by token, fp32
inside, for clarity not speed. Counterpart of ``repro.kernels.ref``.

Shapes follow the (B, S, H, D) convention used by the models.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """O(S^2) attention; k/v already at the query head count."""
    from repro_torch.models.layers import attention_reference
    return attention_reference(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention_ref(q, k_cache, v_cache, cache_len, return_lse=False):
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k_cache, v_cache, cache_len, return_lse)


# -- RWKV6 (Finch) WKV recurrence ---------------------------------------------
#
# Per head, with r_t, k_t, w_t in R^dk, v_t in R^dv, bonus u in R^dk and
# state S in R^{dk x dv}:
#     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)        (readout + bonus)
#     S_t = diag(w_t) S_{t-1} + k_t v_t^T              (data-dependent decay)

def wkv6_ref(r, k, v, w, u, initial_state=None):
    """r,k,w: (B,S,H,dk); v: (B,S,H,dv); u: (H,dk);
    initial_state: (B,H,dk,dv) or None. Returns (y fp32, final_state)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,dk,dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


# -- Mamba-2 SSD recurrence ------------------------------------------------------
#
# Per head, scalar decay a_t = exp(dt_t * A) (A < 0), input x_t in R^P,
# B_t, C_t in R^N, state h in R^{P x N}:
#     h_t = a_t h_{t-1} + (dt_t x_t) B_t^T
#     y_t = h_t C_t + D x_t

def ssd_ref(x, dt, A, B, C, D, initial_state=None):
    """x: (b,S,H,P); dt: (b,S,H); A: (H,); B,C: (b,S,H,N); D: (H,).
    Returns (y fp32, final_state (b,H,P,N))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D = (t.float() for t in (x, dt, A, B, C, D))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t] * A[None, :])                    # (b,H)
        upd = (dt[:, t, :, None] * x[:, t])[..., :, None] \
            * B[:, t, :, None, :]
        state = a[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t])
                  + D[None, :, None] * x[:, t])
    return torch.stack(ys, dim=1), state


# -- grouped GEMM (lax.ragged_dot) -------------------------------------------

def grouped_matmul_ref(x, w, group_sizes):
    """Each row times its own expert's matrix, the expert found from the
    prefix sums of ``group_sizes``; rows past the last group 0. fp32
    inside, x's dtype out. Materialises (C, K, N): tests only."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(x.shape[0], device=x.device)
    expert = torch.searchsorted(ends, rows, right=True)
    live = expert < w.shape[0]
    wr = w[expert.clamp(max=w.shape[0] - 1)].float()
    out = torch.einsum("ck,ckn->cn", x.float(), wr)
    return (out * live[:, None]).to(x.dtype)
