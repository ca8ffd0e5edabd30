"""Plain torch oracles for the kernels (the ground truth for allclose tests).

Deliberately naive, like ``repro/kernels/ref.py``: materialized score
matrices, fp32 throughout. Each wrapper runs its oracle for CPU tensors,
and the card checks compare each kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1.0e30


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
