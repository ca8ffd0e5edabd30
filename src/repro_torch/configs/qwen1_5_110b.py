"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen1.5-110b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        head_dim=16,
        attn_chunk=32,
        compute_dtype="float32",
    )
