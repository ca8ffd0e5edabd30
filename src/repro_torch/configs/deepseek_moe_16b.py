"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained;
first layer dense (d_ff=10944). [arXiv:2401.06066; hf]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,           # the single dense layer's FFN
    vocab=102400,
    head_dim=128,
    rope_theta=10_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    first_k_dense=1,
    capacity_factor=1.25,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="deepseek-moe-16b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab=256,
        head_dim=16,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        expert_d_ff=32,
        first_k_dense=1,
        attn_chunk=32,
        compute_dtype="float32",
    )
