"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,        # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="mamba2-2.7b-smoke",
        n_layers=2,
        d_model=64,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        compute_dtype="float32",
    )
