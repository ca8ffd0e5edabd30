"""Plain torch oracles for the kernels (the ground truth for allclose tests).

Deliberately naive, like ``repro/kernels/ref.py``: materialized score
matrices, fp32 throughout. Each wrapper runs its oracle for CPU tensors,
and the card checks compare each kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    s = torch.einsum("bkgd,bkwd->bkgw", qr, k_cache.float())
    qp = q_pos[:, None]
    valid = (cache_pos >= 0) & (cache_pos <= qp)
    if window is not None:
        valid &= qp - cache_pos < window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    o = torch.einsum("bkgw,bkwd->bkgd", p, v_cache.float())
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


def moe_gmm_ref(x, w):
    """x [E,C,D]; w [E,D,F] -> [E,C,F] in x's dtype, summed in fp32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
