"""Shared layers: RMSNorm, embeddings, RoPE, MLPs (torch)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamSpec
from repro_torch.runtime.sharding import einsum, is_dtensor


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(dtype)


# --------------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------------- #
def embed_specs(vocab: int, d: int) -> dict:
    return {
        "tok": ParamSpec((vocab, d), ("vocab", "embed"), init="embed", scale=0.02),
    }


def unembed_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), ("embed", "vocab"), init="fan_in")


def embed(tokens: torch.Tensor, tok_w: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    if is_dtensor(tok_w) and all(p.is_replicate() for p in tok_w.placements):
        return _replicated_lookup(tokens, tok_w, compute_dtype)
    return tok_w[tokens.long()].to(compute_dtype)


def _replicated_lookup(tokens, tok_w, compute_dtype):
    """The lookup in a replicated table, on each rank's tokens: the rows
    stay where the tokens are, and the table's gradient is each rank's
    partial sum (DTensor's own index would gather the gradient rows of
    every rank and scatter them all on each)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    tp = (tokens.placements if is_dtensor(tokens)
          else (Replicate(),) * tok_w.device_mesh.ndim)
    grad = tuple(Replicate() if p.is_replicate() else Partial() for p in tp)
    return local_map(lambda t, w: w[t.long()].to(compute_dtype),
                     out_placements=list(tp),
                     in_placements=(tuple(tp) if is_dtensor(tokens) else None,
                                    tuple(tok_w.placements)),
                     in_grad_placements=(tuple(tp) if is_dtensor(tokens) else None,
                                         grad),
                     device_mesh=tok_w.device_mesh)(tokens, tok_w)


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return einsum("bsd,dv->bsv", x, w.to(x.dtype))


# --------------------------------------------------------------------------- #
# RoPE (split halves, not interleaved; + M-RoPE for qwen2-vl)
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,           # [B, S, H, D]
    positions: torch.Tensor,   # [B, S] int  or  [3, B, S] for M-RoPE
    theta: float,
    mrope_sections: Optional[tuple[int, ...]] = None,
) -> torch.Tensor:
    """Rotary embedding. With ``mrope_sections`` (in *pair* units summing to
    D/2), frequency band j is driven by position stream i, the (temporal,
    h, w) stream whose contiguous section holds j: qwen2-vl's multimodal
    RoPE in the JAX package's layout (not Hugging Face's interleaved one)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                 # [D/2]
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[0]
        angles = positions[..., None].float() * freqs              # [B,S,D/2]
    else:
        assert positions.ndim == 3, "M-RoPE needs [3, B, S] positions"
        assert sum(mrope_sections) == d // 2, (mrope_sections, d)
        pos_per_freq = torch.cat(
            [positions[i][..., None].float().expand(*positions.shape[1:], n)
             for i, n in enumerate(mrope_sections)], dim=-1)       # [B,S,D/2]
        angles = pos_per_freq * freqs
    cos = torch.cos(angles)[:, :, None, :]                         # [B,S,1,D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
def mlp_specs(d: int, ff: int, act: str) -> dict:
    if act == "silu":  # SwiGLU: gate+up+down
        return {
            "gate": ParamSpec((d, ff), ("embed", "mlp"), init="fan_in"),
            "up": ParamSpec((d, ff), ("embed", "mlp"), init="fan_in"),
            "down": ParamSpec((ff, d), ("mlp", "embed"), init="fan_in"),
        }
    # classic 2-matrix GeLU FFN (hubert)
    return {
        "w1": ParamSpec((d, ff), ("embed", "mlp"), init="fan_in"),
        "b1": ParamSpec((ff,), ("mlp",), init="zeros"),
        "w2": ParamSpec((ff, d), ("mlp", "embed"), init="fan_in"),
        "b2": ParamSpec((d,), ("embed",), init="zeros"),
    }


def mlp(params: dict, x: torch.Tensor, act: str, sharder=None) -> torch.Tensor:
    dt = x.dtype
    if act == "silu":
        g = einsum("bsd,df->bsf", x, params["gate"].to(dt))
        u = einsum("bsd,df->bsf", x, params["up"].to(dt))
        h = F.silu(g) * u
        return einsum("bsf,fd->bsd", h, params["down"].to(dt))
    h = einsum("bsd,df->bsf", x, params["w1"].to(dt))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h + params["b1"].to(dt), approximate="tanh")
    return einsum("bsf,fd->bsd", h, params["w2"].to(dt)) \
        + params["b2"].to(dt)


# --------------------------------------------------------------------------- #
# modality frontends (stubs, as in the JAX package: precomputed embeddings)
# --------------------------------------------------------------------------- #
def frontend_proj_spec(d_in: int, d: int) -> ParamSpec:
    return ParamSpec((d_in, d), ("embed", None), init="fan_in")


def frontend_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return einsum("bsi,id->bsd", x, w.to(x.dtype))
