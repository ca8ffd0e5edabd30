"""Architecture & shape configuration.

One ``ArchConfig`` per assigned architecture lives in
``src/repro/configs/<id>.py`` with the exact published hyperparameters, plus
a ``smoke()`` reduced config of the same family for CPU tests.

The four assigned input shapes are global (every LM arch pairs with all
four, modulo documented skips — see DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_ARCH_IDS = [
    "qwen1_5_110b",
    "smollm_360m",
    "command_r_plus_104b",
    "h2o_danube_3_4b",
    "mamba2_2_7b",
    "deepseek_moe_16b",
    "grok_1_314b",
    "recurrentgemma_9b",
    "qwen2_vl_7b",
    "hubert_xlarge",
]

# public ids use dashes (CLI-friendly); module names use underscores
def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    encoder_only: bool = False
    swa_window: Optional[int] = None  # sliding-window attention (danube)
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    frontend: str = "token"           # token | patch | frame (stubs for vlm/audio)
    frontend_dim: int = 0             # embedding dim provided by the stub
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_aux_loss: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma / Griffin) ---
    lru_width: int = 0
    local_window: int = 2048
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    # --- numerics & execution ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_backend: str = "chunked"     # reference | chunked | pallas
    attn_chunk: int = 1024
    remat: str = "full"               # none | full | dots
    #: scan over stacked layers (constant-size HLO). The dry-run's roofline
    #: probes set False on 1-2 layer variants: cost_analysis() counts a scan
    #: body ONCE regardless of trip count, so per-layer costs are derived
    #: from unrolled probes (see launch/dryrun.py).
    scan_layers: bool = True
    #: nested remat around attention: recompute attention internals during
    #: the block's backward instead of saving per-chunk softmax residuals —
    #: the pure-JAX stand-in for the Pallas flash kernel's recompute-bwd
    #: (§Perf iteration I8). Costs one extra attention forward.
    remat_attention: bool = False
    mlp_act: str = "silu"             # silu (swiglu) | gelu (classic 2-mat)
    z_loss: float = 0.0
    # --- optimizer selection (grok needs adafactor to fit one pod) ---
    optimizer: str = "adamw"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (bounded state/window)"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window is not None

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def param_count_analytic(self) -> int:
        """Approximate N for MODEL_FLOPS=6ND (embeddings included once)."""
        from repro_torch.models.registry import build_param_specs
        from repro_torch.models.base import param_count

        return param_count(build_param_specs(self))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(arch: "ArchConfig", shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch, shape) a runnable dry-run cell? Returns (ok, reason)."""
    if shape.kind == "decode" and not arch.supports_decode:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic path for 500k"
    return True, ""


def get_arch(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    return mod.smoke()


def list_archs() -> list[str]:
    return list(_ARCH_IDS)
