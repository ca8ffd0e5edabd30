"""Losses. Port of ``repro/train/loss.py``: the token-mean cross entropy
in fp32, with an optional z-loss, the accuracy and the token count."""

from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0,
            ignore_id: int = -1) -> tuple[torch.Tensor, dict]:
    """Token-mean cross entropy. logits [B,S,V]; labels [B,S] int32; a
    label equal to ``ignore_id`` counts for nothing."""
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)                         # [B,S]
    safe_labels = labels.long().clamp_min(0)
    ll = l32.gather(-1, safe_labels[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore_id).float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    metrics = {
        "ce_loss": loss,
        "tokens": denom,
        "accuracy": ((l32.argmax(-1) == labels) * mask).sum() / denom,
    }
    if z_loss:
        zl = z_loss * ((lse ** 2) * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
