"""Shared layers: RMSNorm, embeddings, RoPE, MLPs (torch)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamSpec


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
    return tok_w[tokens.long()].to(compute_dtype)


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


# --------------------------------------------------------------------------- #
# RoPE (split halves, not interleaved)
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,           # [B, S, H, D]
    positions: torch.Tensor,   # [B, S] int
    theta: float,
    mrope_sections: Optional[tuple[int, ...]] = None,
) -> torch.Tensor:
    if mrope_sections is not None:
        raise NotImplementedError("M-RoPE arrives with the VLM slice (ROADMAP M9)")
    if positions.ndim == 3:
        positions = positions[0]
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                 # [D/2]
    angles = positions[..., None].float() * freqs                  # [B,S,D/2]
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
        g = torch.einsum("bsd,df->bsf", x, params["gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, params["up"].to(dt))
        h = F.silu(g) * u
        return torch.einsum("bsf,fd->bsd", h, params["down"].to(dt))
    h = torch.einsum("bsd,df->bsf", x, params["w1"].to(dt))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h + params["b1"].to(dt), approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["w2"].to(dt)) \
        + params["b2"].to(dt)
