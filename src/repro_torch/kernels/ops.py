"""Model-layout entry points to the kernels.

The model keeps activations as ``[B,S,H,D]`` and caches as ``[B,W,KV,D]``;
the attention kernels take ``[B,H,S,D]`` and ``[B,KV,W,D]``. Where the JAX
adapters copy with ``swapaxes``, these pass transposed views: the CUDA
kernels read them through their strides (and K2 writes its output in model
layout). K3, K4 and K5 take the model's layouts as they are (the
expert-major dispatch buffer; ``[B,S,H,P]`` for the SSD scan, which the JAX
kernel wrapper moves to ``[B,H,S,P]`` with copies; ``[B,S,W]`` for the
RG-LRU scan).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,D]; k, v [B,T,KV,D] (model layout) -> [B,S,H,D]."""
    o = _fa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
    return o.transpose(1, 2)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_pos: torch.Tensor, q_pos: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q [B,H,D]; caches [B,W,KV,D] (model layout) -> [B,H,D]."""
    return _dec.flash_decode(q, k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), cache_pos, q_pos,
                             window=window)


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] (any row strides); w [E,D,F] -> [E,C,F] in x's dtype."""
    return _gmm.moe_gmm(x, w)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H]; A [H]; Bm, Cm [B,S,N] (model layout) ->
    (y [B,S,H,P], final state [B,H,P,N] fp32)."""
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b [B,S,W]; h0 [B,W] fp32 (model layout) -> (y [B,S,W] in a's
    dtype, final state [B,W] fp32)."""
    return _rg.rglru_scan(a, b, h0)


def rglru_gated(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
                log_a_base: torch.Tensor, h0: torch.Tensor):
    """K5's gated entry, the one the model takes on the card: r, i, x
    [B,S,W] (the gates' sigmoids and the block's input, one dtype);
    log_a_base [W] fp32; h0 [B,W] fp32 -> (y [B,S,W] in x's dtype, final
    state [B,W] fp32). The decay and gated input never reach device
    memory."""
    return _rg.rglru_gated(r, i, x, log_a_base, h0)
