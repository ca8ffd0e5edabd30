"""Architecture registry: config -> model instance / specs."""

from __future__ import annotations

from repro_torch.models.transformer import LM


def build_model(cfg) -> LM:
    return LM(cfg)


def build_param_specs(cfg) -> dict:
    return LM(cfg).param_specs()
