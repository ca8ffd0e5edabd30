"""Model inputs for decode: a fresh cache and synthetic tokens/positions."""

from __future__ import annotations

import torch

from repro_torch.models.base import init_tree
from repro_torch.models.registry import build_model


def make_decode_inputs(cfg, B: int, max_len: int, generator: torch.Generator,
                       device, *, pos: int = 0):
    """(cache, tokens [B] int32, positions [B] int32) on ``device``; the
    cache is empty (k, v zeros; pos -1). ``generator`` lives on ``device``."""
    if cfg.frontend != "token" or cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: decode inputs for the "
                                  f"{cfg.family} family (ROADMAP M9)")
    model = build_model(cfg)
    cache = init_tree(generator, model.cache_specs(B, max_len),
                      cfg.param_dtype, device)
    tok = torch.randint(0, cfg.vocab, (B,), generator=generator, device=device,
                        dtype=torch.int32)
    p = torch.full((B,), pos, dtype=torch.int32, device=device)
    return cache, tok, p
