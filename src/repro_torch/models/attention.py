"""Attention: GQA with full / sliding-window / bidirectional masks, for
the full sequence (prefill, K2) and for decode against an in-place ring KV
cache (K1).

Port of ``repro/models/attention.py``. Backends of ``multihead_attention``:

  * ``reference`` materializes the score matrix everywhere (the oracle);
  * ``chunked`` and ``pallas`` run the hand-written flash-attention kernel
    (K2) on CUDA tensors: the JAX package calls its chunked backend
    structurally identical to the kernel, and the configs default to it,
    so the port's path on the card goes through the kernel whatever the
    config says, as decode goes through K1. On CPU tensors ``chunked`` is
    the streaming softmax over KV chunks (a Python loop in place of
    ``lax.scan``) and ``pallas`` is the kernel's plain version. Under
    grad mode K2's backward re-runs ``_chunked_attention``, the path the
    JAX model differentiates (``kernels/ops.py``).

The JAX decode step returns a new cache and donates the old one; here the
new token's K, V and position are written into the cache tensors in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import apply_rope
from repro_torch.runtime.sharding import einsum, is_dtensor

_NEG = -1.0e30


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


# --------------------------------------------------------------------------- #
# masks
# --------------------------------------------------------------------------- #
def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, mode: str,
          window: Optional[int]) -> torch.Tensor:
    """[S_q, S_k] boolean validity mask."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    if mode == "bidir":
        m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    else:
        m = qp >= kp
    if window is not None:
        m = m & (qp - kp < window)
    return m


# --------------------------------------------------------------------------- #
# full-sequence attention (prefill)
# --------------------------------------------------------------------------- #
def _reference_attention(q, k, v, mode, window):
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = (q * (D ** -0.5)).reshape(B, S, KV, G, D)
    s = einsum("bskgd,btkd->bkgst", qr.float(), k.float())
    dev = q.device
    m = _mask(torch.arange(S, device=dev), torch.arange(T, device=dev), mode,
              window)
    s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def _chunked_attention(q, k, v, mode, window, chunk):
    """Streaming-softmax (flash) attention: a loop over KV chunks."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, T)
    if T % chunk != 0:  # pad KV to a chunk multiple; padded keys are masked
        pad = chunk - T % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nc = k.shape[1] // chunk
    dev = q.device
    qr = (q.float() * (D ** -0.5)).reshape(B, S, KV, G, D)
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, KV, G, S), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, S, D), dtype=torch.float32, device=dev)
    for ci in range(nc):
        ki = k[:, ci * chunk:(ci + 1) * chunk].float()
        vi = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = einsum("bskgd,bckd->bkgsc", qr, ki)
        kv_pos = ci * chunk + torch.arange(chunk, device=dev)
        valid = _mask(q_pos, kv_pos, mode, window) & (kv_pos < T)[None, :]
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum("bkgsc,bckd->bkgsd", p, vi)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return out.to(q.dtype)


def multihead_attention(q, k, v, *, mode: str = "causal",
                        window: Optional[int] = None,
                        backend: str = "chunked", chunk: int = 1024):
    """q [B,S,H,D]; k,v [B,T,KV,D] with H % KV == 0 (GQA). DTensors run
    on each rank's shards (``kernels/ops.py attention_on_shards``)."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return kops.attention_on_shards(
            lambda q, k, v: multihead_attention(q, k, v, mode=mode, window=window,
                                                backend=backend, chunk=chunk),
            q, k, v)
    if backend == "reference":
        return _reference_attention(q, k, v, mode, window)
    if backend not in ("chunked", "pallas"):
        raise ValueError(f"unknown attention backend {backend}")
    if backend == "pallas" or q.device.type == "cuda":
        return kops.flash_attention(q, k, v, causal=(mode != "bidir"),
                                    window=window)
    return _chunked_attention(q, k, v, mode, window, chunk)


# --------------------------------------------------------------------------- #
# block-level forward (projections + rope + attention)
# --------------------------------------------------------------------------- #
def attention_block(params: dict, cfg, sharder, x: torch.Tensor,
                    positions: torch.Tensor, *, mode: str,
                    window: Optional[int] = None) -> torch.Tensor:
    dt = x.dtype
    wq = sharder.gather(params["wq"].to(dt), "embed", "heads", None)
    wk = sharder.gather(params["wk"].to(dt), "embed", "kv_heads", None)
    wv = sharder.gather(params["wv"].to(dt), "embed", "kv_heads", None)
    wo = sharder.gather(params["wo"].to(dt), "heads", None, "embed")
    q = einsum("bsd,dhk->bshk", x, wq)
    k = einsum("bsd,dhk->bshk", x, wk)
    v = einsum("bsd,dhk->bshk", x, wv)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = sharder.constrain(q, "act_batch", None, "act_heads", None)
    k = sharder.constrain(k, "act_batch", None, "kv_heads", None)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    o = multihead_attention(
        q, k, v, mode=mode, window=window,
        backend=cfg.attn_backend, chunk=cfg.attn_chunk,
    )
    o = sharder.constrain(o, "act_batch", None, "act_heads", None)
    return einsum("bshk,hkd->bsd", o, wo)


# --------------------------------------------------------------------------- #
# decode (single new token against a cache)
# --------------------------------------------------------------------------- #
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


def ring_write(buf, slots: torch.Tensor, value: torch.Tensor) -> None:
    """buf[b, slots[b]] = value[b] for every row b, in place, on a DTensor
    ring (the cache split along its batch and its ring dim, "kv_batch" and
    "kv_seq"), on each rank's block: the values and slots move to the
    ring's batch split, and each rank writes the rows whose slot falls in
    its part of the ring (the others write their slot's own value back: no
    shape depends on the data)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    as_dt = lambda t: t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    coord = mesh.get_coordinate()
    v_pl, s_pl, ring = [], [], 0
    for i, p in enumerate(buf.placements):
        d = p.dim % buf.ndim if isinstance(p, Shard) else None
        v_pl.append(Shard(0) if d == 0 else Shard(d - 1) if d and d > 1 else Replicate())
        s_pl.append(Shard(0) if d == 0 else Replicate())
        if d == 1:
            ring = ring * mesh.size(i) + coord[i]
    local = buf.to_local()
    w0 = ring * local.shape[1]
    vals = as_dt(value).redistribute(mesh, v_pl).to_local().to(buf.dtype)
    rel = as_dt(slots).redistribute(mesh, s_pl).to_local() - w0
    hit = (rel >= 0) & (rel < local.shape[1])
    idx = rel.clamp(0, local.shape[1] - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    keep = local[bidx, idx]
    hit = hit.reshape(hit.shape + (1,) * (keep.ndim - 1))
    local[bidx, idx] = torch.where(hit, vals, keep)


def attention_decode(params: dict, cfg, sharder, x: torch.Tensor,
                     cache: dict, positions: torch.Tensor, *,
                     window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """x [B,1,d]; positions [B] int32 absolute position of the new token (or
    [3,B] M-RoPE position streams for the VLM: the temporal stream [0]
    drives the cache slot, the stored position and the mask).

    Writes the token into slot ``pos % W`` of ``cache`` (a ring; for full
    attention W is max_len, so the ring is a linear cache) and returns
    (y [B,1,d], cache)."""
    if positions.ndim == 2:  # [3, B] M-RoPE streams
        rope_pos = positions[:, :, None]  # [3,B,1]
        positions = positions[0]
    else:
        rope_pos = positions[:, None]     # [B,1]
    dt = x.dtype
    B = x.shape[0]
    W = cache["k"].shape[1]
    q = einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)

    slots = (positions % W).long()
    if is_dtensor(cache["k"]):
        ring_write(cache["k"], slots, k[:, 0])
        ring_write(cache["v"], slots, v[:, 0])
        ring_write(cache["pos"], slots, positions)
    else:
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, slots] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slots] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bidx, slots] = positions.to(torch.int32)

    # a [3,B] tensor's stream 0 may be strided: K1 takes a contiguous q_pos
    o = kops.flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                          cache["pos"], positions.to(torch.int32).contiguous(),
                          window=window)                        # [B,H,D]
    y = einsum("bshk,hkd->bsd", o[:, None], params["wo"].to(dt))
    return y, cache
