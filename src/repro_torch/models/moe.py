"""Mixture-of-Experts layer (deepseek-moe, grok-1) in torch.

Port of ``repro/models/moe.py``: top-k routing in fp32 with per-row
capacity and drops, the load-balancing aux loss and the router z-loss,
optional shared experts, and SwiGLU expert FFNs.

Where the JAX layer builds its dispatch buffer ``[B, E, C, d]`` (rows
first, to keep position-in-expert cumsums shard-local), this one builds it
expert-major, ``[E, B, C, d]``: viewed as ``[E, B*C, d]`` it is the
grouped product's x as it is, so the three expert products run the
hand-written kernel K3 (``ops.moe_gmm``) with no transposed copy. The
values are the JAX layer's; only the buffer's axis order differs. As in
JAX, a dropped (token, choice) goes to a trash row, so no shape depends
on the routing. Under DTensors the per-row positions, dispatch and
combine run on each rank's rows of the batch (``on_batch_shards``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.runtime.sharding import einsum, on_batch_shards


def moe_specs(cfg) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    specs = {
        "router": ParamSpec((d, E), ("embed", "experts"), init="fan_in",
                            dtype="float32"),
        "wg": ParamSpec((E, d, ff), ("experts", "embed", "mlp"), init="fan_in"),
        "wu": ParamSpec((E, d, ff), ("experts", "embed", "mlp"), init="fan_in"),
        "wd": ParamSpec((E, ff, d), ("experts", "mlp", "embed"), init="fan_in"),
    }
    if cfg.n_shared_experts:
        specs["shared"] = mlp_specs(d, cfg.n_shared_experts * ff, "silu")
    return specs


def _capacity(tokens_per_row: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(tokens_per_row * top_k * cf / n_experts) + 1
    return max(4, min(c, tokens_per_row * top_k))


def top_k_gates(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest router probabilities of each token, renormalised to
    sum to 1, and their experts: (gates [B,S,K] fp32, experts [B,S,K])."""
    gates, eidx = torch.topk(probs, k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def expert_positions(eidx: torch.Tensor, E: int, C: int):
    """Each routed token's slot in its expert, counted along its row (choice
    j of every token before choice j + 1), and whether it fits: (pos [B,S,K],
    keep [B,S,K])."""
    B = eidx.shape[0]
    pos_list = []
    counts = torch.zeros((B, E), dtype=torch.int64, device=eidx.device)
    for j in range(eidx.shape[-1]):
        oh = F.one_hot(eidx[..., j], E)                              # [B,S,E]
        pos_full = oh.cumsum(dim=1) - oh + counts[:, None, :]
        pos_list.append(pos_full.gather(-1, eidx[..., j, None])[..., 0])
        counts = counts + oh.sum(dim=1)
    pos = torch.stack(pos_list, dim=-1)
    return pos, pos < C


def _dispatch(x: torch.Tensor, eidx: torch.Tensor, pos_k: torch.Tensor,
              keep_k: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The expert-major buffer [E*B*C, d]: row (e*B + b)*C + p holds the
    token of row b that took slot p of expert e, zeros where none did.
    Every (token, choice) is copied, a dropped one into a trash row E*B*C
    that is then cut off, so nothing here depends on the routing's data
    (no mask, no ``nonzero``: no host sync and a traceable shape)."""
    B, S, d = x.shape
    K = eidx.shape[-1]
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = torch.where(keep_k, (eidx * B + rows) * C + pos_k, E * B * C)
    src = x[:, :, None, :].expand(B, S, K, d).reshape(B * S * K, d)
    buf = torch.zeros((E * B * C + 1, d), dtype=x.dtype, device=x.device)
    return buf.index_copy_(0, slot.reshape(-1), src)[:E * B * C]


def _combine(out_e: torch.Tensor, eidx: torch.Tensor, pos_k: torch.Tensor,
             keep_k: torch.Tensor, gate_vals: torch.Tensor, C: int) -> torch.Tensor:
    """y [B,S,d]: each token's kept choices read back from the experts'
    outputs out_e [E, B*C, d] and summed with their gates."""
    B, S, K = eidx.shape
    E, d = out_e.shape[0], out_e.shape[-1]
    rows = torch.arange(B, device=out_e.device)[:, None, None]
    slot = (eidx * B + rows) * C + pos_k
    slot = torch.where(keep_k, slot, E * B * C - 1)
    vals = out_e.reshape(E * B * C, d)[slot]                    # [B,S,K,d]
    gates = torch.where(keep_k, gate_vals, 0.0).to(out_e.dtype)
    return einsum("bskd,bsk->bsd", vals, gates)


def moe_block(params: dict, cfg, sharder, x: torch.Tensor, *,
              impl: str = "scatter") -> tuple[torch.Tensor, dict]:
    """x: [B, S, d] -> (y [B, S, d], aux losses)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, E, K, cfg.capacity_factor)
    dt = x.dtype

    # ---- routing (fp32) ------------------------------------------------- #
    logits = einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = top_k_gates(probs, K)                     # [B,S,K]

    # ---- aux losses ------------------------------------------------------ #
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = F.one_hot(eidx, E).float().mean(dim=(0, 1)).sum(0) / K
    aux_loss = cfg.moe_aux_loss * E * torch.sum(me * ce)
    z_loss = 1e-3 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    pos_k, keep_k = on_batch_shards(lambda e: expert_positions(e, E, C), x,
                                    (eidx,), (0,), (0, 0))      # [B,S,K]

    if impl == "scatter":
        # JAX's ``where(keep, eidx, E)`` with ``mode="drop"``
        x_e = on_batch_shards(lambda *a: _dispatch(*a, E, C).view(E, -1, d), x,
                              (x, eidx, pos_k, keep_k), (0, 0, 0, 0), (1,))
    elif impl == "onehot":  # reference; small shapes only
        disp = (F.one_hot(eidx, E)[..., None] * F.one_hot(pos_k.clamp_max(C - 1), C)[..., None, :]
                * keep_k[..., None, None]).float().sum(2)       # [B,S,E,C]
        x_e = einsum("bsec,bsd->ebcd", disp, x.float()).to(dt).reshape(E, B * C, d)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    x_e = sharder.constrain(x_e, "act_experts", "act_batch", None)

    # ---- expert FFNs (SwiGLU) on K3 --------------------------------------- #
    g = kops.moe_gmm(x_e, params["wg"].to(dt))
    u = kops.moe_gmm(x_e, params["wu"].to(dt))
    h = F.silu(g) * u
    out_e = kops.moe_gmm(h, params["wd"].to(dt))                # [E,B*C,d]

    # ---- combine --------------------------------------------------------- #
    if impl == "scatter":
        y = on_batch_shards(lambda *a: _combine(*a, C), x,
                            (out_e, eidx, pos_k, keep_k, gate_vals), (1, 0, 0, 0, 0),
                            (0,))
    else:
        cw = (F.one_hot(eidx, E)[..., None] * F.one_hot(pos_k.clamp_max(C - 1), C)[..., None, :]
              * (gate_vals * keep_k)[..., None, None]).float().sum(2)
        y = einsum("bsec,ebcd->bsd", cw,
                   out_e.reshape(E, B, C, d).float()).to(dt)

    # ---- shared experts (deepseek) ---------------------------------------- #
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x, "silu", sharder)

    return y, {"moe_aux": aux_loss, "moe_z": z_loss}
