"""Parameter system of the port: ``ParamSpec`` trees become nested dicts of
torch tensors with the JAX tree's exact keys.

``init_tree`` draws from a ``torch.Generator`` and cannot reproduce
``jax.random``; ``params_from_numpy`` carries a JAX tree (after
``np.asarray`` on each leaf) into the port, which is how the parity tests
hand both packages the same weights. Both place their tensors on the CUDA
card unless the caller names another device (``resolve_device``).

For the dry run a spec tree also becomes ``meta`` tensors
(``abstract_tree``: shapes and dtypes, no storage), its logical axes
(``axes_tree``) and the DTensor placements a ``Sharder`` resolves them to
(``shardings_tree``).
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


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree shaped like ``tree`` whose leaves are taken from ``leaves`` in
    sorted-key order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def tree_index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda t: t[i], tree)


def tree_unstack(tree: Any) -> list:
    """The layers of a stacked tree, as a list of trees of views. Each leaf
    is unbound once, so a backward through a loop over the layers stacks a
    leaf's gradients once (indexing layer by layer would write a gradient
    of the whole stack for every layer)."""
    if isinstance(tree, dict):
        per_key = {k: tree_unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and a
    CUDA device where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found (pass device='cpu' to run "
                           "the plain path on the CPU)")
    return dev


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
    # scaled in place: a stacked expert leaf drawn for a bf16 tree is 20 GB
    # in fp32 at deepseek-moe-16b's width, and a second fp32 copy would
    # not fit beside the rest of the tree on an 80 GB card
    return x.mul_(std).to(dtype)


def init_tree(generator: torch.Generator, specs: Any,
              param_dtype: str = "float32", device=None) -> Any:
    """Materialize real parameters, leaves drawn in sorted-key order, on
    ``device`` (None: the CUDA card).

    ``generator`` must live on ``device`` (``torch.randn`` requires it)."""
    device = resolve_device(device)

    def build(tree: Any) -> Any:
        # draw in sorted-key order, the order jax.tree_util flattens in
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return _init_leaf(tree, torch_dtype(tree.dtype or param_dtype),
                          generator, device)

    return build(specs)


def _resolve_dtype(spec: ParamSpec, default: str) -> torch.dtype:
    return torch_dtype(spec.dtype or default)


def abstract_tree(specs: Any, param_dtype: str = "float32", device="meta") -> Any:
    """Stand-ins with each leaf's shape and resolved dtype and no storage:
    tensors on the ``meta`` device (or, under a ``FakeTensorMode``, fake
    tensors of ``device``)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=_resolve_dtype(s, param_dtype),
                                          device=device), specs)


def axes_tree(specs: Any) -> Any:
    """The logical-axes tree mirroring the param tree."""
    return tree_map(lambda s: s.axes, specs)


def shardings_tree(specs: Any, sharder, param_dtype: str = "float32") -> Any:
    """Each leaf's DTensor placements on ``sharder``'s mesh."""
    return tree_map(lambda s: sharder.sharding(s.shape, s.axes), specs)


def param_count(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs: Any, param_dtype: str = "float32") -> int:
    return sum(math.prod(s.shape) * _resolve_dtype(s, param_dtype).itemsize
               for s in tree_leaves(specs))


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
    as the port's tree: same keys, same values, tensors on ``device``
    (None: the CUDA card)."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device), tree)
