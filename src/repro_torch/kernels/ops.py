"""Model-layout entry points to the kernels.

The model keeps activations as ``[B,S,H,D]`` and caches as ``[B,W,KV,D]``;
the kernels take ``[B,H,S,D]`` and ``[B,KV,W,D]``. Where the JAX adapters
copy with ``swapaxes``, these pass transposed views: the CUDA kernels read
them through their strides (and K2 writes its output in model layout).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa


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
