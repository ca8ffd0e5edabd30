"""Parameter system of the port: ``ParamSpec`` trees become nested dicts of
torch tensors with the JAX tree's exact keys.

``init_tree`` draws from a ``torch.Generator`` and cannot reproduce
``jax.random``; ``params_from_numpy`` carries a JAX tree (after
``np.asarray`` on each leaf) into the port, which is how the parity tests
hand both packages the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"          # zeros | ones | const | normal | fan_in | embed
    scale: Optional[float] = None  # stddev override (or the const value)
    dtype: Optional[str] = None    # override the model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.axes}")

    def stacked(self, n: int, axis_name: str = "layers") -> "ParamSpec":
        """Add a leading layer dimension (stacked per-layer params)."""
        return ParamSpec(
            (n, *self.shape), (axis_name, *self.axes), self.init, self.scale, self.dtype
        )


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


# --------------------------------------------------------------------------- #
# nested-dict trees
# --------------------------------------------------------------------------- #
def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order (the order ``jax.tree_util`` uses)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda t: t[i], tree)


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# --------------------------------------------------------------------------- #
# initialisation
# --------------------------------------------------------------------------- #
def _init_leaf(spec: ParamSpec, dtype: torch.dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    kind, shape = spec.init, spec.shape
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "const":
        return torch.full(shape, spec.scale, dtype=dtype, device=device)
    if kind == "normal":
        std = spec.scale if spec.scale is not None else 0.02
    elif kind == "fan_in":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = (spec.scale or 1.0) / math.sqrt(max(fan_in, 1))
    elif kind == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    else:
        raise ValueError(f"unknown init {kind}")
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def init_tree(generator: torch.Generator, specs: Any,
              param_dtype: str = "float32", device=None) -> Any:
    """Materialize real parameters, leaves drawn in sorted-key order.

    ``generator`` must live on ``device`` (``torch.randn`` requires it)."""
    def build(tree: Any) -> Any:
        # draw in sorted-key order, the order jax.tree_util flattens in
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return _init_leaf(tree, torch_dtype(tree.dtype or param_dtype),
                          generator, device)

    return build(specs)


def param_count(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


# --------------------------------------------------------------------------- #
# the weight carry
# --------------------------------------------------------------------------- #
def _from_numpy(a: Any, device) -> torch.Tensor:
    a = np.array(a)  # a private copy the tensor can own
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, *, device=None) -> Any:
    """A tree of numpy arrays (e.g. a JAX ``init_tree`` after ``np.asarray``)
    as the port's tree: same keys, same values, tensors on ``device``."""
    return tree_map(lambda a: _from_numpy(a, device), tree)
