"""Weights drawn from the seed on the device, one call a leaf of the
layer-stacked tree, in the type they are used in, as the source model's
own initialisation draws them (Hugging Face's Llama ``_init_weights``):
every matrix and the embedding normal(0, ``initializer_range``), every
norm scale one. The layout (keys, shapes, which leaves are norms) is the
checkpoint format's, read from the model's parameter specs; the values
are the benchmark's, so the plain reference can draw the same tree again
without the program.

The port's own ``init_tree`` scales each matrix by 1 / sqrt(fan-in); at
32 layers that makes smollm-360m chaotic (bf16's logits decorrelate from
float32's entirely), so no comparison could tell bfloat16 from float8."""

from __future__ import annotations

import torch


def _leaf(spec, dtype: torch.dtype, std: float, gen: torch.Generator,
          device) -> torch.Tensor:
    if spec.init in ("zeros", "ones", "const"):
        value = {"zeros": 0.0, "ones": 1.0}.get(spec.init, spec.scale)
        return torch.full(spec.shape, value, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def make_params(specs: dict, param_dtype: str, seed: int, device, std: float) -> dict:
    """The weight tree of ``specs`` (leaves drawn in sorted-key order from
    one generator seeded with ``seed`` on ``device``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return _leaf(tree, getattr(torch, tree.dtype or param_dtype), std, gen, device)

    return build(specs)
