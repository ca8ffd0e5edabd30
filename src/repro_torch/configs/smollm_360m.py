"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    rope_theta=10_000.0,
    mlp_act="silu",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="smollm-360m-smoke",
        n_layers=2,
        d_model=60,
        n_heads=3,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        head_dim=20,
        attn_chunk=32,
        compute_dtype="float32",
    )
