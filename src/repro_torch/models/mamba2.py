"""Mamba-2 (SSD, state-space duality) mixer block [arXiv:2405.21060] in torch.

Port of ``repro/models/mamba2.py``. The full-sequence scan runs the
hand-written kernel K4 (``ops.ssd_scan``) on CUDA tensors; on CPU tensors
it runs ``ssd_chunked``, the JAX model's own chunked algebra (a Python
loop over chunks in place of ``lax.scan``), which is also the plain
yardstick the card checks hold K4 against. The decode step has no kernel,
as in JAX; it updates its cache (conv buffer and fp32 state) in place.

Recurrence (per head h, discretized):
    a_t = exp(dt_t * A)                 (A < 0)
    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t + D * x_t
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import rmsnorm
from repro_torch.runtime.sharding import einsum


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nh, hd, ds = _dims(cfg)
    k = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, d_inner), ("embed", "mlp"), init="fan_in"),
        "wx": ParamSpec((d, d_inner), ("embed", "mlp"), init="fan_in"),
        "wB": ParamSpec((d, ds), ("embed", "state"), init="fan_in"),
        "wC": ParamSpec((d, ds), ("embed", "state"), init="fan_in"),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads"), init="fan_in"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "conv_w": ParamSpec((k, d_inner), ("conv", "mlp"), init="normal",
                            scale=0.1),
        "conv_b": ParamSpec((d_inner,), ("mlp",), init="zeros"),
        "norm": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "wo": ParamSpec((d_inner, d), ("mlp", "embed"), init="fan_in"),
    }


def published_dt_A(params: dict, generator: torch.Generator) -> dict:
    """``params`` (an LM tree) with each mixer's A_log and dt_bias drawn as
    Mamba-2's reference code draws them: A uniform in [1, 16] and dt
    log-uniform in [1e-3, 1e-1] through the inverse softplus. The specs'
    init (as the JAX package's) has A = -1 and dt_bias = 0, so dt is
    softplus of the projection, ~0.7, and a full-width stack is chaotic."""
    mixer = dict(params["layers"]["mixer"])
    like = mixer["A_log"]
    A = torch.empty(like.shape, device=like.device).uniform_(1, 16, generator=generator)
    dt = torch.empty(like.shape, device=like.device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator).exp()
    mixer["A_log"] = torch.log(A).to(like.dtype)
    mixer["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(mixer["dt_bias"].dtype)
    return {**params, "layers": {**params["layers"], "mixer": mixer}}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. x [B,S,Ci], w [K,Ci]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K=4: unrolled taps (elementwise FMAs)
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Chunked SSD scan, the JAX model's algebra.

    x [B,S,H,P]; dt [B,S,H] (>0); A [H] (<0); Bm, Cm [B,S,N] (n_groups=1).
    Returns y [B,S,H,P] in x's dtype and the final state [B,H,P,N] fp32.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for s0 in range(0, S, Q):
        xq32 = x[:, s0:s0 + Q].float()                     # [B,Q,H,P]
        dtq = dt[:, s0:s0 + Q].float()                     # [B,Q,H]
        Bq = Bm[:, s0:s0 + Q].float()                      # [B,Q,N]
        Cq = Cm[:, s0:s0 + Q].float()
        cum = torch.cumsum(dtq * A, dim=1)                 # [B,Q,H], negative
        # intra-chunk: scores_ij = (C_i.B_j) * exp(cum_i - cum_j) * dt_j
        CB = einsum("bin,bjn->bij", Cq, Bq)                # [B,Q,Q]
        decay = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                      -60.0, 0.0))         # [B,Q,Q,H]
        scores = CB[..., None] * decay * dtq[:, None, :, :]
        scores = torch.where(tri[None, :, :, None], scores, 0.0)
        y_intra = einsum("bijh,bjhp->bihp", scores, xq32)
        # cross-chunk: y_i += exp(cum_i) * C_i . h_in
        y_cross = einsum("bin,bhpn->bihp", Cq, h) * torch.exp(cum)[..., None]
        # state update: h' = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
        last = cum[:, -1:, :]                              # [B,1,H]
        w = torch.exp(torch.clamp(last - cum, -60.0, 0.0)) * dtq
        h = (torch.exp(last[:, 0])[:, :, None, None] * h
             + einsum("bjh,bjn,bjhp->bhpn", w, Bq, xq32))
        ys.append((y_intra + y_cross).to(x.dtype))
    return torch.cat(ys, dim=1), h


def _scan(xh, dtv, A, Bm, Cm, chunk):
    """K4 on CUDA tensors, the model's chunked algebra elsewhere."""
    if xh.is_cuda:
        return kops.ssd_scan(xh, dtv, A, Bm, Cm, chunk=chunk)
    return ssd_chunked(xh, dtv, A, Bm, Cm, chunk)


def _in_proj(params, x):
    """z, x-branch, B, C and dt (fp32, softplus) of x [B,S,d]."""
    dt_ = x.dtype
    z = einsum("bsd,di->bsi", x, params["wz"].to(dt_))
    xi = einsum("bsd,di->bsi", x, params["wx"].to(dt_))
    Bm = einsum("bsd,dn->bsn", x, params["wB"].to(dt_))
    Cm = einsum("bsd,dn->bsn", x, params["wC"].to(dt_))
    # torch returns x itself past 20, where log(1 + exp(x)) rounds to x
    # in fp32 anyway: the values of jax.nn.softplus
    dtv = F.softplus(
        einsum("bsd,dh->bsh", x, params["wdt"].to(dt_)).float()
        + params["dt_bias"].float())
    return z, xi, Bm, Cm, dtv


def mamba2_block(params: dict, cfg, sharder, x: torch.Tensor, *,
                 return_state: bool = False):
    """Full-sequence mixer. x [B,S,d] -> y [B,S,d] (+ the final state if
    asked). The JAX block's ``h0`` and ``conv_state`` (a prefill
    continuation, unimplemented there) have no caller and are left out."""
    dt_ = x.dtype
    d_inner, nh, hd, ds = _dims(cfg)
    B, S, _ = x.shape

    z, xi, Bm, Cm, dtv = _in_proj(params, x)
    xi = sharder.constrain(xi, "act_batch", None, "act_mlp")
    xi = F.silu(_causal_conv(xi, params["conv_w"].to(dt_), params["conv_b"].to(dt_)))

    A = -torch.exp(params["A_log"].float())
    xh = xi.reshape(B, S, nh, hd)
    y, h_final = _scan(xh, dtv, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * params["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    # gated RMSNorm (mamba2): norm(y) * silu(z)
    y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    out = einsum("bsi,id->bsd", y, params["wo"].to(dt_))
    if return_state:
        return out, h_final
    return out


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def mamba2_cache_specs(cfg, batch: int) -> dict:
    d_inner, nh, hd, ds = _dims(cfg)
    k = cfg.ssm_conv
    return {
        "h": ParamSpec((batch, nh, hd, ds), ("kv_batch", "ssm_heads", None, None),
                       init="zeros", dtype="float32"),
        "conv": ParamSpec((batch, k - 1, d_inner), ("kv_batch", None, "mlp"),
                          init="zeros", dtype=cfg.compute_dtype),
    }


def mamba2_decode(params: dict, cfg, sharder, x: torch.Tensor, cache: dict):
    """Single-token step. x [B,1,d] -> (y [B,1,d], cache), the cache's conv
    buffer and state updated in place."""
    dt_ = x.dtype
    d_inner, nh, hd, ds = _dims(cfg)
    B = x.shape[0]

    z, xi, Bm, Cm, dtv = (t[:, 0] for t in _in_proj(params, x))  # dtv [B,H]

    # causal conv against the rolling buffer
    conv = cache["conv"]
    conv_in = torch.cat([conv, xi[:, None, :].to(conv.dtype)], dim=1)
    w = params["conv_w"].to(dt_)  # [K, Ci]
    conv_out = einsum("bki,ki->bi", conv_in.to(dt_), w) + params["conv_b"].to(dt_)
    xi = F.silu(conv_out)
    conv.copy_(conv_in[:, 1:, :])

    A = -torch.exp(params["A_log"].float())
    xh = xi.reshape(B, nh, hd).float()
    a = torch.exp(dtv * A)  # [B,H]
    h = cache["h"] * a[:, :, None, None] + einsum(
        "bh,bn,bhp->bhpn", dtv, Bm.float(), xh)
    cache["h"].copy_(h)
    y = einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * params["D"].float()[None, :, None]
    y = y.reshape(B, d_inner).to(dt_)
    y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    out = einsum("bi,id->bd", y, params["wo"].to(dt_))[:, None, :]
    return out, cache
