"""Losses. Port of ``repro/train/loss.py``: the token-mean cross entropy
in fp32, with an optional z-loss, the accuracy and the token count."""

from __future__ import annotations

import torch

from repro_torch.runtime.sharding import is_dtensor


def _vocab_split(l32: torch.Tensor) -> bool:
    """Is ``l32`` a DTensor split along its last (vocab) dim?"""
    from torch.distributed.tensor import Shard

    return is_dtensor(l32) and any(
        isinstance(p, Shard) and p.dim % l32.ndim == l32.ndim - 1
        for p in l32.placements)


def _logsumexp(l32: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim. Split along the vocab, the max and the
    sum of exp(x - max) are each a reduction of the ranks' partial results
    (DTensor's own logsumexp gathers the whole vocabulary on every rank)."""
    if _vocab_split(l32):
        m = l32.amax(dim=-1, keepdim=True).detach()
        return (l32 - m).exp().sum(dim=-1).log() + m[..., 0]
    return torch.logsumexp(l32, dim=-1)


def _label_logit(l32: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """l32[..., labels]. Split along the vocab, the masked sum over it (a
    rank's own label logits, a partial sum reduced across the vocab's
    ranks: the vocab-parallel form; DTensor's gather along a split dim
    masks its index buffer as an embedding's [N, D] and fails on
    [B, S, V]). The sum adds zeros to the one label logit: the gather's
    value."""
    if _vocab_split(l32):
        vocab = torch.arange(l32.shape[-1], dtype=torch.int32, device=labels.device)
        hit = vocab == labels[..., None]
        return torch.where(hit, l32, torch.zeros((), device=l32.device)).sum(-1)
    return l32.gather(-1, labels[..., None])[..., 0]


def _argmax(l32: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim. Split along the vocab, the first index of
    the max by two reductions (DTensor's argmax handler converts local
    indices through the data, which a traced step has not)."""
    if _vocab_split(l32):
        V = l32.shape[-1]
        vocab = torch.arange(V, dtype=torch.int32, device=l32.device)
        at_max = l32 == l32.amax(-1, keepdim=True)
        return torch.where(at_max, vocab, V).amin(-1)
    return l32.argmax(-1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0,
            ignore_id: int = -1) -> tuple[torch.Tensor, dict]:
    """Token-mean cross entropy. logits [B,S,V]; labels [B,S] int32; a
    label equal to ``ignore_id`` counts for nothing."""
    l32 = logits.float()
    lse = _logsumexp(l32)                                      # [B,S]
    safe_labels = labels.long().clamp_min(0)
    ll = _label_logit(l32, safe_labels)
    nll = lse - ll
    mask = (labels != ignore_id).float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    metrics = {
        "ce_loss": loss,
        "tokens": denom,
        "accuracy": ((_argmax(l32) == labels) * mask).sum() / denom,
    }
    if z_loss:
        zl = z_loss * ((lse ** 2) * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
