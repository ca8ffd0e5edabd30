"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 (cluster units), encoder-only (wav2vec2 architecture).
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, masked-unit-prediction training,
NO autoregressive decode — decode_32k / long_500k cells are skipped (see
DESIGN.md §Arch-applicability). The waveform conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings [B, S, 512]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    encoder_only=True,
    mlp_act="gelu",
    frontend="frame",
    frontend_dim=512,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="hubert-xlarge-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab=64,
        head_dim=16,
        frontend_dim=32,
        attn_chunk=32,
        compute_dtype="float32",
    )
