"""Model-layout entry points to the kernels.

The model keeps caches as ``[B,W,KV,D]``; the kernels take ``[B,KV,W,D]``.
Where the JAX adapters copy with ``swapaxes``, these pass a transposed view:
the CUDA kernel reads it through its strides.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_pos: torch.Tensor, q_pos: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q [B,H,D]; caches [B,W,KV,D] (model layout) -> [B,H,D]."""
    return _dec.flash_decode(q, k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), cache_pos, q_pos,
                             window=window)
