"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE (temporal/h/w sections), dynamic resolution.
[arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings [B, S, d_model] plus the 3-stream
M-RoPE position ids [3, B, S]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # pairs: sums to head_dim/2 = 64
    frontend="patch",
    frontend_dim=3584,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen2-vl-7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        head_dim=16,
        mrope_sections=(2, 3, 3),
        frontend_dim=64,
        attn_chunk=32,
        compute_dtype="float32",
    )
