"""Synthetic model inputs: full-sequence batches (prefill) and, for decode,
a fresh cache with tokens and positions.

Batch layout, as in ``repro/launch/inputs.py``:
  prefill: {tokens [B,S] int32 | embeds [B,S,Din], positions [B,S] int32}
  train:   the same plus labels [B,S] int32
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.base import init_tree, torch_dtype
from repro_torch.models.registry import build_model


def make_batch(cfg, B: int, S: int, generator: torch.Generator, device, *,
               with_labels: bool = True) -> dict:
    """Random tokens (or frame/patch embeddings in the compute dtype) and
    positions ``arange(S)`` for every row, on ``device``; ``generator``
    lives on ``device``."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE position streams arrive "
                                  f"with the VLM slice (ROADMAP M9)")
    batch: dict[str, Any] = {}
    if cfg.frontend == "token":
        batch["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=generator,
                                        device=device, dtype=torch.int32)
    else:
        d_in = cfg.frontend_dim or cfg.d_model
        batch["embeds"] = torch.randn(
            (B, S, d_in), generator=generator, device=device,
        ).to(torch_dtype(cfg.compute_dtype))
    batch["positions"] = torch.arange(S, dtype=torch.int32,
                                      device=device).expand(B, S)
    if with_labels:
        batch["labels"] = torch.randint(0, cfg.vocab, (B, S), generator=generator,
                                        device=device, dtype=torch.int32)
    return batch


def make_decode_inputs(cfg, B: int, max_len: int, generator: torch.Generator,
                       device, *, pos: int = 0):
    """(cache, tokens [B] int32, positions [B] int32) on ``device``; the
    cache is empty (attention: k, v zeros, pos -1; mamba2: conv buffer and
    state zeros; hybrid: each local-attention layer a ring of
    ``min(local_window, max_len)`` slots, each recurrent block an fp32
    state and a conv buffer of zeros). ``generator`` lives on ``device``."""
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


def conditioned(cfg, params):
    """``params`` with wq, wk and wv rescaled to std 1/sqrt(d_model).

    The model's init (as the JAX package's) takes the fan-in of wq [d,H,hd]
    and wk, wv [d,KV,hd] as H and KV, so at full width q and k entries have
    std ~8 and ~14 and attention scores std ~100: a near-hard argmax that
    turns a last-bit difference into an O(1) logit change (ROADMAP Queue
    3). With the d_model fan-in the scores are O(1), as in a trained model,
    and a logits comparison measures the kernels rather than that
    amplification.
    The attention blocks are the stacks "layers" and "dense_layers", and
    the hybrid's superblocks' "attn"."""

    def scaled(block):
        attn = dict(block["attn"])
        for key, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                       ("wv", cfg.n_kv_heads)):
            attn[key] = attn[key] * math.sqrt(n / cfg.d_model)
        return {**block, "attn": attn}

    out = dict(params)
    for stack in ("layers", "dense_layers"):
        if "attn" in params.get(stack, {}):
            out[stack] = scaled(params[stack])
    if "superblocks" in params:
        sb = params["superblocks"]
        out["superblocks"] = {**sb, "attn": scaled(sb["attn"])}
    return out
