"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

SWA makes this the one *dense* arch that supports long_500k decode
(O(window) ring-buffer KV cache)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    swa_window=4096,
    rope_theta=10_000.0,
    mlp_act="silu",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="h2o-danube-3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        head_dim=16,
        swa_window=16,
        attn_chunk=16,
        compute_dtype="float32",
    )
