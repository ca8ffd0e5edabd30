"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) expert d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

Trains with Adafactor (factored second moments, no first moment) so the
optimizer state fits a single 256-chip v5e pod at 16 GB/chip — see
DESIGN.md §5 and EXPERIMENTS.md §Dry-run."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    rope_theta=10_000.0,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    expert_d_ff=32768,
    first_k_dense=0,
    capacity_factor=1.25,
    optimizer="adafactor",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="grok-1-314b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        head_dim=16,
        n_experts=4,
        top_k=2,
        expert_d_ff=96,
        attn_chunk=32,
        compute_dtype="float32",
    )
