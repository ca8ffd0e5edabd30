"""Model inputs: ``meta``-tensor stand-ins for the dry run (shapes and
dtypes, no storage: the counterpart of the JAX ``ShapeDtypeStruct``s) and
synthetic full-sequence batches (prefill) and, for decode, a fresh cache
with tokens and positions.

Batch layout, as in ``repro/launch/inputs.py``:
  prefill: {tokens [B,S] int32 | embeds [B,S,Din],
            positions [B,S] int32 (or [3,B,S] for M-RoPE)}
  train:   the same plus labels [B,S] int32
  decode:  (cache, tokens [B] int32 | embeds [B,1,Din],
            positions [B] int32 (or [3,B] for M-RoPE))
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.base import abstract_tree, init_tree, torch_dtype
from repro_torch.models.registry import build_model


def _spec(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg, B: int, S: int, *, with_labels: bool,
                device="meta") -> dict:
    """{tokens [B,S] int32 | embeds [B,S,Din] compute dtype, positions
    [B,S] ([3,B,S] under M-RoPE) int32[, labels [B,S] int32]}."""
    specs: dict[str, Any] = {}
    if cfg.frontend == "token":
        specs["tokens"] = _spec((B, S), torch.int32, device)
    else:
        d_in = cfg.frontend_dim or cfg.d_model
        specs["embeds"] = _spec((B, S, d_in), torch_dtype(cfg.compute_dtype),
                                device)
    pos = (3, B, S) if cfg.mrope_sections is not None else (B, S)
    specs["positions"] = _spec(pos, torch.int32, device)
    if with_labels:
        specs["labels"] = _spec((B, S), torch.int32, device)
    return specs


def batch_axes(cfg, *, with_labels: bool) -> dict:
    """The logical axes of each key of ``batch_specs``: the batch dim is
    "batch" (under M-RoPE the positions' second)."""
    axes: dict[str, Any] = {}
    if cfg.frontend == "token":
        axes["tokens"] = ("batch", None)
    else:
        axes["embeds"] = ("batch", None, None)
    axes["positions"] = ((None, "batch", None) if cfg.mrope_sections is not None
                         else ("batch", None))
    if with_labels:
        axes["labels"] = ("batch", None)
    return axes


def decode_axes(cfg) -> tuple[Any, Any]:
    """The logical axes of ``decode_specs``' tokens (or embeddings) and
    positions."""
    tok = ("batch",) if cfg.frontend == "token" else ("batch", None, None)
    pos = (None, "batch") if cfg.mrope_sections is not None else ("batch",)
    return tok, pos


def decode_specs(cfg, B: int, max_len: int, device="meta") -> tuple[Any, Any, Any]:
    """(cache, tokens [B] int32 | embeds [B,1,Din], positions [B] | [3,B])."""
    model = build_model(cfg)
    cache = abstract_tree(model.cache_specs(B, max_len), cfg.param_dtype, device)
    if cfg.frontend == "token":
        tok = _spec((B,), torch.int32, device)
    else:
        d_in = cfg.frontend_dim or cfg.d_model
        tok = _spec((B, 1, d_in), torch_dtype(cfg.compute_dtype), device)
    pos = (3, B) if cfg.mrope_sections is not None else (B,)
    return cache, tok, _spec(pos, torch.int32, device)


def input_specs(cfg, shape, device="meta") -> dict:
    """The stand-ins of an (arch, shape) cell's inputs."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, B, S, with_labels=True, device=device)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, B, S, with_labels=False, device=device)}
    if shape.kind == "decode":
        cache, tok, pos = decode_specs(cfg, B, S, device)
        return {"cache": cache, "tokens": tok, "positions": pos}
    raise ValueError(shape.kind)


def make_batch(cfg, B: int, S: int, generator: torch.Generator, device, *,
               with_labels: bool = True) -> dict:
    """Random tokens (or frame/patch embeddings in the compute dtype) and
    positions ``arange(S)`` for every row (under M-RoPE three equal
    streams of it), on ``device``; ``generator`` lives on ``device``."""
    batch: dict[str, Any] = {}
    if cfg.frontend == "token":
        batch["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=generator,
                                        device=device, dtype=torch.int32)
    else:
        d_in = cfg.frontend_dim or cfg.d_model
        batch["embeds"] = torch.randn(
            (B, S, d_in), generator=generator, device=device,
        ).to(torch_dtype(cfg.compute_dtype))
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    batch["positions"] = pos if cfg.mrope_sections is None else pos.expand(3, B, S)
    if with_labels:
        batch["labels"] = torch.randint(0, cfg.vocab, (B, S), generator=generator,
                                        device=device, dtype=torch.int32)
    return batch


def make_decode_inputs(cfg, B: int, max_len: int, generator: torch.Generator,
                       device, *, pos: int = 0):
    """(cache, tokens [B] int32 or embeddings [B,1,Din] in the compute
    dtype for a non-token frontend, positions [B] int32 or [3,B] under
    M-RoPE) on ``device``; the cache is empty (attention: k, v zeros, pos
    -1; mamba2: conv buffer and state zeros; hybrid: each local-attention
    layer a ring of ``min(local_window, max_len)`` slots, each recurrent
    block an fp32 state and a conv buffer of zeros). ``generator`` lives on
    ``device``."""
    model = build_model(cfg)
    cache = init_tree(generator, model.cache_specs(B, max_len),
                      cfg.param_dtype, device)
    if cfg.frontend == "token":
        tok = torch.randint(0, cfg.vocab, (B,), generator=generator,
                            device=device, dtype=torch.int32)
    else:
        d_in = cfg.frontend_dim or cfg.d_model
        tok = torch.randn((B, 1, d_in), generator=generator,
                          device=device).to(torch_dtype(cfg.compute_dtype))
    p = torch.full((B,), pos, dtype=torch.int32, device=device)
    if cfg.mrope_sections is not None:
        p = p.expand(3, B)
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
