"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; unverified]

38 layers = 12 scanned superblocks of (rec, rec, local-attn) + 2 unrolled
trailing recurrent blocks. Sub-quadratic: long_500k runs (O(1) LRU state +
O(window) local-attention ring cache)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    rope_theta=10_000.0,
    lru_width=4096,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    ssm_conv=4,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="recurrentgemma-9b-smoke",
        n_layers=5,            # 1 superblock + 2 tail rec blocks
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        head_dim=16,
        lru_width=64,
        local_window=16,
        attn_chunk=16,
        compute_dtype="float32",
    )
