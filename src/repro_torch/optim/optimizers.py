"""Optimizers, param-tree generic. Port of ``repro/optim/optimizers.py``.

* AdamW: fp32 moments, decoupled weight decay on every leaf, bias
  correction by the step count, the update in fp32 cast back to the
  param's dtype.
* Adafactor: factored second moments for >=2-D params (rank-1 outer
  approximation), no first moment, RMS update clipping; on ``[L, ...]``
  stacks of at least ``chunk_stacked`` layers the update (and its
  clipping) runs a layer slice at a time, as the JAX ``lax.map`` does.

Written out rather than taken from ``torch.optim``: its AdamW couples the
decay and rounds differently, and torch has no Adafactor with these
semantics. Where the JAX functions return new trees (and the trainer
donates the old ones), these write params and state in place, under
``torch.no_grad()``, and return the same trees. The count is a 0-d int32
tensor on the params' device and the bias corrections are computed there,
so an update never waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.models.base import tree_leaves, tree_map


def _walk(params: Any, *others: Any) -> Iterator[tuple]:
    """(param, the matching subtree of each of ``others``) for every leaf
    of ``params``, in sorted-key order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _walk(params[k], *(o[k] for o in others))
    else:
        yield (params, *others)


def _count(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def adamw_init(params: Any) -> dict:
    zeros = lambda p: _zeros(p.shape, p)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": _count(params)}


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: dict,
    params: Any,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[Any, dict]:
    state["count"] += 1
    c = state["count"].float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    for p, g, m, v in _walk(params, grads, state["m"], state["v"]):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, state


# --------------------------------------------------------------------------- #
# Adafactor (factored, momentum-free)
# --------------------------------------------------------------------------- #
def _factored(shape: tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Any) -> dict:
    def per_param(p):
        if _factored(p.shape):
            return {"vr": _zeros(p.shape[:-1], p),
                    "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        return {"v": _zeros(p.shape, p)}

    return {"f": tree_map(per_param, params), "count": _count(params)}


@torch.no_grad()
def adafactor_update(
    grads: Any,
    state: dict,
    params: Any,
    *,
    lr,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    chunk_stacked: int = 8,
) -> tuple[Any, dict]:
    """``chunk_stacked``: update big ``[L, ...]`` stacks a layer slice at a
    time, as the JAX update maps over the leading dim; the RMS clipping is
    then per slice, which changes the numbers, so it is kept."""
    state["count"] += 1
    c = state["count"].float()
    beta2 = 1.0 - c ** (-decay)

    def upd(g, f, p):
        g32 = g.float()
        g2 = g32.square() + eps
        if _factored(p.shape):
            vr = beta2 * f["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * f["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            f["vr"].copy_(vr)
            f["vc"].copy_(vc)
        else:
            vhat = beta2 * f["v"] + (1 - beta2) * g2
            f["v"].copy_(vhat)
        u = g32 / torch.sqrt(vhat + eps)
        rms = torch.sqrt(u.square().mean() + eps)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        p.copy_(p.float() - lr * (u + weight_decay * p.float()))

    for p, g, f in _walk(params, grads, state["f"]):
        if chunk_stacked and p.ndim >= 3 and p.shape[0] >= chunk_stacked:
            for i in range(p.shape[0]):
                upd(g[i], {k: t[i] for k, t in f.items()}, p[i])
        else:
            upd(g, f, p)
    return params, state


# --------------------------------------------------------------------------- #
# factory
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], dict]
    update: Callable[..., tuple[Any, dict]]


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer(
            "adamw",
            adamw_init,
            lambda g, s, p, lr: adamw_update(g, s, p, lr=lr, **kw),
        )
    if name == "adafactor":
        return Optimizer(
            "adafactor",
            adafactor_init,
            lambda g, s, p, lr: adafactor_update(g, s, p, lr=lr, **kw),
        )
    raise ValueError(f"unknown optimizer {name}")
