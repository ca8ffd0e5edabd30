"""Attention for decode: GQA projections, RoPE, an in-place ring KV cache
and flash decode (K1).

Port of ``repro/models/attention.py`` (``attn_specs``, ``cache_specs``,
``attention_decode``). The JAX step returns a new cache and donates the old
one; here the new token's K, V and position are written into the cache
tensors in place. Full-sequence attention (``multihead_attention``,
``attention_block``) arrives with the prefill slice (ROADMAP, slice 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import apply_rope


def attn_specs(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return specs


def cache_specs(cfg, batch: int, max_len: int, *, window: Optional[int]) -> dict:
    """Per-layer KV cache specs. ``window`` bounds the buffer (ring) for
    SWA/local attention; full attention stores max_len."""
    W = min(window, max_len) if window else max_len
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": ParamSpec((batch, W, KV, hd), ("kv_batch", "kv_seq", "kv_heads", None),
                       init="zeros", dtype=cfg.compute_dtype),
        "v": ParamSpec((batch, W, KV, hd), ("kv_batch", "kv_seq", "kv_heads", None),
                       init="zeros", dtype=cfg.compute_dtype),
        # absolute position stored in each slot; -1 = empty
        "pos": ParamSpec((batch, W), ("kv_batch", "kv_seq"),
                         init="const", scale=-1, dtype="int32"),
    }


def attention_decode(params: dict, cfg, sharder, x: torch.Tensor,
                     cache: dict, positions: torch.Tensor, *,
                     window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """x [B,1,d]; positions [B] int32 absolute position of the new token.

    Writes the token into slot ``pos % W`` of ``cache`` (a ring; for full
    attention W is max_len, so the ring is a linear cache) and returns
    (y [B,1,d], cache)."""
    if positions.ndim != 1:
        raise NotImplementedError("M-RoPE decode arrives with the VLM slice "
                                  "(ROADMAP M9)")
    dt = x.dtype
    B = x.shape[0]
    W = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    rope_pos = positions[:, None]
    q = apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)

    slots = (positions % W).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slots] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)

    o = kops.flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                          cache["pos"], positions.to(torch.int32),
                          window=window)                        # [B,H,D]
    y = torch.einsum("bshk,hkd->bsd", o[:, None], params["wo"].to(dt))
    return y, cache
