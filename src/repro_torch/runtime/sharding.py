"""Logical-axis sharding rules on a ``DeviceMesh``: the port of
``repro/runtime/sharding.py``.

Every parameter and key activation carries *logical* axis names ("embed",
"heads", "vocab", "act_seq", ...). A rule table maps each logical axis to
its preferred mesh axes; ``logical_to_spec`` resolves them against a mesh
with the JAX algorithm, **auto-dropping** mesh axes that are absent, that
another dimension of the same tensor already took, or that do not divide
the dimension. Its result is a tuple equal, part for part, to the JAX
``PartitionSpec``; ``spec_to_placements`` turns it into DTensor
placements (one per mesh dimension).

The ``Sharder``'s hooks (``constrain``, ``gather``, ``sp_boundary``) act on
DTensors through ``redistribute``, the counterpart of
``with_sharding_constraint``; a plain tensor, and anything given to a
mesh-less Sharder, passes through unchanged, so the one-card paths are as
they were.
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

# logical axis -> ordered mesh-axis preference
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "act_batch": ("pod", "data"),
    "act_seq": ("model",),          # sequence parallelism (Megatron-SP style)
    "act_embed": (),                 # replicated within a row by default
    "act_heads": ("model",),        # tensor parallel attention activations
    "act_mlp": ("model",),
    "act_vocab": ("model",),        # sharded logits for the softmax/CE
    "act_experts": ("model",),
    # parameters
    "embed": ("data",),              # FSDP-style parameter sharding
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_heads": ("model",),
    "lru": ("model",),
    "head_dim": (),
    "state": (),
    "conv": (),
    "layers": (),                    # the stacked layer dim: never sharded
    # kv-cache
    "kv_batch": ("pod", "data"),
    "kv_seq": ("model",),           # flash-decode style split-KV
}

Spec = tuple  # parts: None, a mesh-axis name, or a tuple of names


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh: Any,
    rules: Optional[Mapping[str, tuple[str, ...]]] = None,
) -> Spec:
    """Resolve logical axes to a spec for ``mesh`` (a ``DeviceMesh`` or a
    mapping from axis name to size).

    Drops (a) mesh axes not present in the mesh, (b) axes already used by
    another dim of this tensor, (c) axes whose size doesn't divide the dim.
    Trailing unsharded dims are trimmed, as the JAX spec trims them.
    """
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes} rank mismatch")
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            parts.append(None)
            continue
        keep: list[str] = []
        prod = 1
        for m in rules.get(ax, ()):
            size = sizes.get(m)
            if size is None or m in used:
                continue
            if dim % (prod * size) == 0:
                keep.append(m)
                prod *= size
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(tuple(keep))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that shards tensor dim ``d``, ``Replicate()`` on the others.

    A dim over two mesh axes, as in ("pod", "data"), becomes two
    ``Shard(d)``; DTensor splits a dim by its mesh dimensions in mesh order,
    so the spec's major-to-minor order must be the mesh's (it raises
    otherwise)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list[Any] = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        order = [names.index(m) for m in group]
        if order != sorted(order):
            raise ValueError(f"spec part {group} is not in the mesh's major-to-"
                             f"minor order {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a tensor that every rank holds whole (a view),
    as ``distribute_tensor`` would place it, with no communication."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t


def from_full(t: torch.Tensor, mesh, placements, device=None):
    """A DTensor of ``placements`` built from a tensor that every rank holds
    whole (same seed, or a checkpoint each rank reads): each rank keeps its
    block, moved to ``device`` if given, so no collective runs (gloo has
    none to scatter CUDA tensors)."""
    local = local_shard(t, mesh, placements)
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def sharded_einsum(eq: str, *operands):
    """``torch.einsum`` over DTensors, planned per mesh dimension as GSPMD
    plans a dot, and run on each rank's shards (``local_map``).

    DTensor's own einsum flattens the operands into a ``bmm`` and may shard
    a merged dim (heads x head_dim) at a cut that no longer unflattens
    ("Cannot unflatten unevenly sharded tensor"); computing the einsum on
    local shards never reshapes a sharded global tensor. For each mesh
    dimension the plan keeps the sharded letter of the largest operand
    (as a rule the activation, so the weight is gathered: FSDP) and moves
    every operand holding that letter onto it, the others to replicas. The output is sharded on the kept letter, or a
    partial sum where the letter is contracted; the gradient of an operand
    that lacks the letter is a partial sum (data parallelism's weight
    gradient). Partial inputs are reduced first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    if len(terms) != len(operands):
        raise ValueError(f"einsum {eq}: {len(operands)} operands")
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    # a plain operand is a replica on every rank (implicit replication)
    ops = [o if is_dtensor(o) else
           DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for o in operands]
    for j, o in enumerate(ops):
        if any(isinstance(p, Partial) for p in o.placements):
            ops[j] = o.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                           else p for p in o.placements])
    targets = [[Replicate()] * mesh.ndim for _ in ops]
    # an operand replicated on a mesh dim whose ranks split the others sees
    # a slice of them: its local gradient is a partial sum over that dim
    grads = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl: list[Any] = []
    for i in range(mesh.ndim):
        # the letter each operand is sharded on along mesh dim i
        held = [(j, terms[j][o.placements[i].dim % o.ndim])
                for j, o in enumerate(ops) if isinstance(o.placements[i], Shard)]
        if not held:
            out_pl.append(Replicate())
            continue
        j_keep, letter = max(held, key=lambda h: ops[h[0]].numel())
        for j, term in enumerate(terms):
            if letter in term:
                targets[j][i] = grads[j][i] = Shard(term.index(letter))
            else:
                grads[j][i] = Partial()
        out_pl.append(Shard(out.index(letter)) if letter in out else Partial())
    for j, o in enumerate(ops):
        if tuple(o.placements) != tuple(targets[j]):
            ops[j] = o.redistribute(mesh, targets[j])
    return local_map(lambda *ts: torch.einsum(eq, *ts),
                     out_placements=list(out_pl),  # a list: one output
                     in_placements=tuple(tuple(t) for t in targets),
                     in_grad_placements=tuple(tuple(g) for g in grads),
                     device_mesh=mesh)(*ops)


def einsum(eq: str, *operands) -> torch.Tensor:
    """``torch.einsum``; where an operand is a DTensor, ``sharded_einsum``,
    which runs it on each rank's shards."""
    if any(is_dtensor(o) for o in operands):
        return sharded_einsum(eq, *operands)
    return torch.einsum(eq, *operands)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, on each rank's
    shard in its placements (for an op DTensor has no rule for)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(x.placements)
    return local_map(fn, out_placements=list(pl), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh)(x)


def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


class Sharder:
    """Carries (mesh, rules) through the model code; a no-op when ``mesh``
    is None.

    ``constrain(x, *axes)`` redistributes a DTensor activation to the spec
    its logical axes resolve to; ``sharding(shape, axes)`` gives a leaf's
    placements (``models.base.shardings_tree`` for a whole tree);
    ``place(t, *axes)`` distributes a tensor every rank holds whole, and
    ``place_tree(axes, tree)`` a tree of them.
    """

    def __init__(self, mesh: Any = None,
                 rules: Optional[Mapping[str, tuple[str, ...]]] = None,
                 *, fsdp_gather: bool = False):
        self.mesh = mesh
        self.rules = dict(rules or DEFAULT_RULES)
        #: when True, ``gather()`` drops the layer weights' FSDP ("embed")
        #: sharding at use time: a ZeRO-3-style all-gather a layer
        self.fsdp_gather = fsdp_gather
        #: when True, ``sp_boundary()`` all-gathers the sequence dim (in the
        #: compute dtype) at attention/MLP entries (Megatron-SP)
        self.explicit_sp = False

    def with_rules(self, overrides: Mapping[str, tuple[str, ...]]) -> "Sharder":
        r = dict(self.rules)
        r.update(overrides)
        return Sharder(self.mesh, r, fsdp_gather=self.fsdp_gather)

    def spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> Spec:
        if self.mesh is None:
            return ()
        return logical_to_spec(shape, axes, self.mesh, self.rules)

    def sharding(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> tuple:
        """The DTensor placements of a leaf of ``shape`` and ``axes``."""
        if self.mesh is None:
            raise ValueError("a Sharder without a mesh has no placements")
        return spec_to_placements(self.spec(shape, axes), self.mesh)

    def place(self, t: torch.Tensor, *axes: Optional[str]):
        """``t`` (held whole by every rank) as a DTensor on its spec."""
        if self.mesh is None:
            return t
        t = t.contiguous()  # an expanded tensor's 0 strides are no layout
        return from_full(t, self.mesh, self.sharding(t.shape, axes))

    def place_tree(self, axes: Any, tree: Any):
        """``tree`` (nested dicts, held whole by every rank) as DTensors,
        each leaf placed by its logical axes in ``axes``, a tree of the same
        keys (``models.base.axes_tree``, ``launch.inputs.batch_axes``); a
        leaf whose axes are None stays a plain tensor (a step counter)."""
        if isinstance(tree, dict):
            return {k: self.place_tree(axes[k], v) for k, v in tree.items()}
        return tree if axes is None else self.place(tree, *axes)

    def scope(self):
        """The context a step runs in: with a mesh, DTensor's implicit
        replication, so the plain tensors the model makes (RoPE tables,
        masks, positions) join DTensor ops as replicas; else nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

    def _to(self, x, placements):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(self.mesh, placements)

    def constrain(self, x, *axes: Optional[str]):
        if self.mesh is None or not is_dtensor(x):
            return x
        return self._to(x, self.sharding(x.shape, axes))

    def sp_boundary(self, x):
        """Explicit Megatron-SP boundary: gather the sequence dim, in the
        compute dtype, on entry to attention/MLP. No-op unless
        ``explicit_sp``."""
        if self.mesh is None or not self.explicit_sp:
            return x
        axes = ("act_batch",) + (None,) * (x.ndim - 1)
        return self.constrain(x, *axes)

    def gather(self, w, *axes: Optional[str]):
        """FSDP use-time weight gather: ``constrain``'s spec with the
        "embed" (FSDP) axis replicated. No-op unless ``fsdp_gather``."""
        if self.mesh is None or not self.fsdp_gather or not is_dtensor(w):
            return w
        rules = dict(self.rules)
        rules["embed"] = ()
        spec = logical_to_spec(w.shape, axes, self.mesh, rules)
        return self._to(w, spec_to_placements(spec, self.mesh))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Sharder(mesh={None if self.mesh is None else mesh_sizes(self.mesh)})"
