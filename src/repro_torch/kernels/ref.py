"""Plain torch oracles for the kernels (the ground truth for allclose tests).

Deliberately naive, like ``repro/kernels/ref.py``: materialized score
matrices, fp32 throughout. Each wrapper runs its oracle for CPU tensors,
and the card checks compare each kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.sharding import einsum

NEG = -1.0e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q [B,H,S,D]; k, v [B,KV,T,D] -> [B,H,S,D]."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, S, D).float() * (D ** -0.5)
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    # in place: at full width the score tensor is the largest allocation
    s.masked_fill_(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    del s
    p.masked_fill_(~mask, 0.0)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, cache_pos, q_pos, *,
                     window: Optional[int] = None):
    """q [B,H,D]; caches [B,KV,W,D]; cache_pos [B,W]; q_pos [B]."""
    B, H, D = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, D).float() * (D ** -0.5)
    s = einsum("bkgd,bkwd->bkgw", qr, k_cache.float())
    qp = q_pos[:, None]
    valid = (cache_pos >= 0) & (cache_pos <= qp)
    if window is not None:
        valid &= qp - cache_pos < window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    o = einsum("bkgw,bkwd->bkgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def ssd_ref(x, dt, A, Bm, Cm):
    """Exact O(S) recurrence. x [B,S,H,P]; dt [B,S,H]; A [H]; Bm, Cm
    [B,S,N]. Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    A = A.float()
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                                # [B,H]
        a = torch.exp(dtt * A)
        h = h * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dtt, Bm[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rglru_ref(a, b, h0):
    """Exact step recurrence h_t = a_t h_{t-1} + b_t in fp32. a, b [B,S,W];
    h0 [B,W]. Returns (y [B,S,W] in a's dtype, h_final [B,W] fp32)."""
    h = h0.float()
    y = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        y[:, t] = h
    return y.to(a.dtype), h


def rglru_decay_input(r, i, x, log_a_base):
    """The RG-LRU's decay and gated input in fp32 (JAX rglru.py:82-86):
    a = exp(8 r log_a_base), b = sqrt(max(1 - exp(2 log a), 1e-12)) i x.
    r, i (the gates' sigmoids) and x in any float dtype, cast first;
    log_a_base = log sigmoid(lambda), fp32, broadcast against them."""
    log_a = 8.0 * r.float() * log_a_base
    a = torch.exp(log_a)
    gated = i.float() * x.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated
    return a, b


def rglru_gated_ref(r, i, x, log_a_base, h0):
    """K5's gated entry: the step recurrence of ``rglru_decay_input`` from
    h0. r, i, x [B,S,W]; log_a_base [W]; h0 [B,W]. Returns (y [B,S,W] in
    x's dtype, h_final [B,W] fp32)."""
    a, b = rglru_decay_input(r, i, x, log_a_base)
    y, h = rglru_ref(a, b, h0)
    return y.to(x.dtype), h


def moe_gmm_ref(x, w):
    """x [E,C,D]; w [E,D,F] -> [E,C,F] in x's dtype, summed in fp32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
