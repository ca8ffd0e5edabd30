"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    qkv_bias=False,
    rope_theta=75_000_000.0,
    mlp_act="silu",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="command-r-plus-104b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        head_dim=16,
        attn_chunk=32,
        compute_dtype="float32",
    )
