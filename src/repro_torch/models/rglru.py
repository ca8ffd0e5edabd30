"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) in torch.

Port of ``repro/models/rglru.py``. On CUDA tensors the full-sequence
recurrence runs K5's gated entry (``gated_scan`` -> ``ops.rglru_gated``):
the hand-written kernel takes the gates' sigmoids and the block's input and
forms the decay and gated input in registers, so they never reach device
memory. On CPU tensors it runs ``associative_scan``, the JAX model's own
algorithm (a log-depth doubling scan over the sequence in place of
``lax.associative_scan``) on ``ref.rglru_decay_input``'s a and b. The
decode step is the O(1) recurrence, as in JAX; it updates its cache (conv
buffer and fp32 state) in place.

Recurrence (per channel, with head-block-diagonal gates):
    r_t = sigmoid(W_a . x_t)        recurrence gate
    i_t = sigmoid(W_x . x_t)        input gate
    a_t = exp(c * r_t * log(sigmoid(Lambda)))          (0 < a_t < 1, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The Griffin *recurrent block* wraps the RG-LRU with: linear-in, causal
depthwise conv (k=4), and a gated (GeLU) side branch, then linear-out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.base import ParamSpec
from repro_torch.models.mamba2 import _causal_conv


def _heads(cfg):
    width = cfg.lru_width or cfg.d_model
    nh = cfg.n_heads
    assert width % nh == 0
    return width, nh, width // nh


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    width, nh, hd = _heads(cfg)
    k = cfg.ssm_conv
    return {
        "w_in": ParamSpec((d, width), ("embed", "lru"), init="fan_in"),
        "w_gate_branch": ParamSpec((d, width), ("embed", "lru"), init="fan_in"),
        "conv_w": ParamSpec((k, width), ("conv", "lru"), init="normal", scale=0.1),
        "conv_b": ParamSpec((width,), ("lru",), init="zeros"),
        # block-diagonal (per-head) gate projections
        "wa": ParamSpec((nh, hd, hd), ("heads", None, None), init="fan_in"),
        "ba": ParamSpec((nh, hd), ("heads", None), init="zeros"),
        "wx": ParamSpec((nh, hd, hd), ("heads", None, None), init="fan_in"),
        "bx": ParamSpec((nh, hd), ("heads", None), init="zeros"),
        "lam": ParamSpec((width,), ("lru",), init="normal", scale=0.5),
        "w_out": ParamSpec((width, d), ("lru", "embed"), init="fan_in"),
    }


def _gates(params, xh):
    """xh [B,S,H,hd] -> (r, i) [B,S,H,hd] in xh's dtype: the einsums and
    sigmoids run in xh's dtype (JAX rglru.py:62-72, which then casts them to
    fp32; here ``ref.rglru_decay_input`` or K5's gated entry casts)."""
    dt_ = xh.dtype
    r = torch.sigmoid(torch.einsum("bshp,hpq->bshq", xh, params["wa"].to(dt_))
                      + params["ba"].to(dt_))
    i = torch.sigmoid(torch.einsum("bshp,hpq->bshq", xh, params["wx"].to(dt_))
                      + params["bx"].to(dt_))
    return r, i


def _log_a_base(params):
    """log sigmoid(lambda) [W] in fp32."""
    return F.logsigmoid(params["lam"].float())


def _decay_and_input(params, xh):
    """xh [B,S,H,hd] -> (a, b) [B,S,H,hd] fp32, the recurrence's decay and
    gated input (``ref.rglru_decay_input``)."""
    nh, hd = xh.shape[-2:]
    r, i = _gates(params, xh)
    return kref.rglru_decay_input(r, i, xh, _log_a_base(params).reshape(nh, hd))


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over dim 1, as the
    log-depth doubling scan of (a, b) pairs under the JAX model's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)`` (rglru.py:93-97)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, shift:] = a[:, :-shift] * a[:, shift:]
        b_new[:, shift:] = b[:, :-shift] * a[:, shift:] + b[:, shift:]
        a, b = a_new, b_new
        shift *= 2
    return b


def rglru_scan(params, cfg, x, h0=None):
    """x [B,S,W] -> (y [B,S,W] in x's dtype, h_final [B,W] fp32)."""
    if x.is_cuda:
        return gated_scan(params, cfg, x, h0)
    B, S, W = x.shape
    width, nh, hd = _heads(cfg)
    a, b = _decay_and_input(params, x.reshape(B, S, nh, hd))
    a, b = a.reshape(B, S, W), b.reshape(B, S, W)
    if h0 is not None:
        # fold h0 into the first step: h_1 = a_1 h0 + b_1 (rglru.py:89-91)
        b[:, 0] += a[:, 0] * h0.reshape(B, W)
    h = associative_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def gated_scan(params, cfg, x, h0=None):
    """The card's path of ``rglru_scan``: the gates, then K5's gated entry
    (``ops.rglru_gated``) on the gates' sigmoids, x and log sigmoid(lambda),
    from h0 (zeros if None). On CPU tensors ``ops.rglru_gated`` runs its
    plain version."""
    B, S, W = x.shape
    width, nh, hd = _heads(cfg)
    r, i = _gates(params, x.reshape(B, S, nh, hd))
    h0 = (x.new_zeros((B, W), dtype=torch.float32) if h0 is None
          else h0.reshape(B, W).float())
    return kops.rglru_gated(r.reshape(B, S, W), i.reshape(B, S, W), x,
                            _log_a_base(params), h0)


def rglru_block(params: dict, cfg, sharder, x: torch.Tensor, h0=None, *,
                return_state: bool = False):
    """Griffin recurrent block. x [B,S,d] -> y [B,S,d] (+ the final state
    if asked)."""
    dt_ = x.dtype
    u = torch.einsum("bsd,dw->bsw", x, params["w_in"].to(dt_))
    u = sharder.constrain(u, "act_batch", None, "act_mlp")
    u = _causal_conv(u, params["conv_w"].to(dt_), params["conv_b"].to(dt_))
    y, h_final = rglru_scan(params, cfg, u, h0)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_gate_branch"].to(dt_)),
                  approximate="tanh")
    out = torch.einsum("bsw,wd->bsd", y * gate, params["w_out"].to(dt_))
    if return_state:
        return out, h_final
    return out


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def rglru_cache_specs(cfg, batch: int) -> dict:
    width, _, _ = _heads(cfg)
    k = cfg.ssm_conv
    return {
        "h": ParamSpec((batch, width), ("kv_batch", "lru"), init="zeros",
                       dtype="float32"),
        "conv": ParamSpec((batch, k - 1, width), ("kv_batch", None, "lru"),
                          init="zeros", dtype=cfg.compute_dtype),
    }


def rglru_decode(params: dict, cfg, sharder, x: torch.Tensor, cache: dict):
    """Single-token step. x [B,1,d] -> (y [B,1,d], cache), the cache's conv
    buffer and state updated in place."""
    dt_ = x.dtype
    width, nh, hd = _heads(cfg)
    B = x.shape[0]
    u = torch.einsum("bsd,dw->bsw", x, params["w_in"].to(dt_))[:, 0]
    conv = cache["conv"]
    conv_in = torch.cat([conv, u[:, None, :].to(conv.dtype)], dim=1)
    u = (torch.einsum("bkw,kw->bw", conv_in.to(dt_), params["conv_w"].to(dt_))
         + params["conv_b"].to(dt_))
    conv.copy_(conv_in[:, 1:, :])

    a, b = _decay_and_input(params, u.reshape(B, 1, nh, hd))
    h = a[:, 0] * cache["h"].reshape(B, nh, hd) + b[:, 0]
    cache["h"].copy_(h.reshape(B, width))
    y = h.reshape(B, width).to(dt_)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x,
                               params["w_gate_branch"].to(dt_))[:, 0],
                  approximate="tanh")
    out = torch.einsum("bw,wd->bd", y * gate, params["w_out"].to(dt_))
    return out[:, None, :], cache
