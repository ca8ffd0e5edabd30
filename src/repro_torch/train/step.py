"""Inference steps: the full-sequence forward (prefill) and the function
the engine calls once per decode token.

Nothing in here checkpoints: the preemption point is the step's call site,
which the serving engine wraps with ``repro_torch.core.autockpt``
(docs/PREEMPTION.md tier 3). The training step arrives with its own slice
(ROADMAP M10).
"""

from __future__ import annotations

from typing import Callable

import torch


def make_prefill_step(model, sharder) -> Callable[[dict, dict], torch.Tensor]:
    """Full-sequence forward (inference prefill): logits only."""

    @torch.inference_mode()
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = model.forward(params, batch, sharder)
        return logits

    return prefill_step


def make_serve_step(model, sharder) -> Callable[..., tuple[torch.Tensor, dict]]:
    """One decode token against a KV cache, updated in place."""

    @torch.inference_mode()
    def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        return model.decode_step(params, cache, tokens, positions, sharder)

    return serve_step
