"""LR schedules. Port of ``repro/optim/schedules.py``."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` of it,
    in fp32 as a 0-d tensor on ``step``'s device (an int step: the CPU).
    A tensor step stays on its device: no host sync."""
    s = (step if isinstance(step, torch.Tensor)
         else torch.tensor(step)).to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)
