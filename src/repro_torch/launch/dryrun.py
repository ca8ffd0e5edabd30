"""Multi-pod dry run and roofline extraction: the port of
``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_110b \\
        --shape train_4k [--multi-pod] [--debug-mesh] [--no-probes]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

For every (arch x shape x mesh) cell this:
  1. traces the PRODUCTION step (``make_train_step`` with microbatches and
     remat, ``make_prefill_step`` or ``make_serve_step``) under
     ``FakeTensorMode`` in a fake world of the mesh's size (``launch/mesh.py
     fake_world``), as rank 0: parameters, optimizer state, batch and cache
     are DTensors placed by the ``Sharder``'s rules, so each aten op runs on
     rank 0's shards, and every collective DTensor issues is recorded;
  2. counts, per device: FLOPs with ``FlopCounterMode`` (local ops only:
     an op on DTensors is counted once, at its shards); bytes as the inputs
     plus outputs of each local aten op (eager torch does not fuse, so
     every op reads and writes device memory: the counterpart of XLA's
     "bytes accessed"; views, allocations and ops that return no tensor
     move nothing and count 0);
     collectives with ``CommDebugMode`` (counts) and their traffic with the
     ring model of ``analysis/hlo.py CollectiveOp``; and the peak of live
     memory (``_memory``: every storage an op creates is live from its
     creation to the release of its last reference, sizes rounded up to the
     CUDA caching allocator's 512-byte blocks; the peak is the largest sum
     along the step, which is what ``torch.cuda.max_memory_allocated``
     reads on a card for the same step). The ops DTensor runs on fake
     global-shaped stand-ins to work out shapes are no device's work and
     are not counted (``_propagation_untallied``);
  3. emits the three roofline terms (``analysis/roofline.py``, H100 rates)
     into results/dryrun_torch/<arch>.<shape>.<mesh>.json.

The layers run unrolled in a Python loop, so the count of the full step
is exact; ``probe_pair``'s 1- and 2-layer probes stay as a check that
their derived total equals it. The step's attention is the chunked plain
path (as JAX's dry run traces its default ``attn_backend="chunked"``): a
traced tensor is on no card, so no kernel runs.

Importing this module starts no process group and sets no environment
variable: each cell opens and closes its own fake world.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Any, Optional

import torch

from repro_torch.analysis.hlo import CollectiveOp
from repro_torch.analysis.roofline import HW, model_flops_analytic, roofline_terms
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_supported, get_arch, list_archs
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import (debug_shape, fake_world, make_mesh,
                                     production_shape)
from repro_torch.models.base import abstract_tree, tree_map
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import _factored
from repro_torch.runtime.sharding import Sharder, is_dtensor
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

#: where the CLI writes its cells (the JAX package's go to results/dryrun)
DEFAULT_OUT = "results/dryrun_torch"
#: the allocator's block granularity (c10 CUDACachingAllocator kMinBlockSize)
_BLOCK = 512


# --------------------------------------------------------------------------- #
# placements for every argument
# --------------------------------------------------------------------------- #
def _placer(sharder):
    """(shape, axes) -> placements, or None (a plain tensor) without a
    mesh."""
    if sharder.mesh is None:
        return lambda shape, axes: None
    return sharder.sharding


def _batch_shardings(cfg, batch_abs, sharder) -> dict:
    sh = _placer(sharder)
    axes = inp.batch_axes(cfg, with_labels="labels" in batch_abs)
    return {k: sh(tuple(t.shape), axes[k]) for k, t in batch_abs.items()}


def _opt_shardings(opt_name: str, specs, sharder):
    sh = _placer(sharder)
    param_sh = lambda s: sh(s.shape, s.axes)
    if opt_name == "adamw":
        tree = tree_map(param_sh, specs)
        return {"m": tree, "v": tree, "count": None}
    if opt_name == "adafactor":
        def fac(s):
            if _factored(s.shape):
                return {
                    "vr": sh(s.shape[:-1], s.axes[:-1]),
                    "vc": sh(s.shape[:-2] + s.shape[-1:],
                             s.axes[:-2] + s.axes[-1:]),
                }
            return {"v": param_sh(s)}

        return {"f": tree_map(fac, specs), "count": None}
    raise ValueError(opt_name)


def _opt_abstract(opt_name: str, params_abs):
    """The optimizer state's stand-ins (meta tensors; "count" a 0-d int32
    that stays a plain tensor, as the step counter does)."""
    return make_optimizer(opt_name).init(params_abs)


# --------------------------------------------------------------------------- #
# cell construction
# --------------------------------------------------------------------------- #
def build_cell(cfg, shape, mesh, *, microbatches: int = 1,
               rules: Optional[dict] = None, fsdp_gather: bool = False,
               explicit_sp: bool = False, accum_dtype: str = "float32"):
    """Returns (fn, abstract_args, in_shardings, out_shardings): the args
    as ``meta`` tensors and their placements (None: a plain tensor every
    rank holds, such as the step counter). A mesh of one device
    distributes nothing: its step runs on plain tensors, the very ops a
    card runs for it (and without DTensor's dispatch per op)."""
    sharder = Sharder(mesh if mesh.size() > 1 else None, rules,
                      fsdp_gather=fsdp_gather)
    sharder.explicit_sp = explicit_sp
    sh = _placer(sharder)
    model = build_model(cfg)
    specs = model.param_specs()
    params_abs = abstract_tree(specs, cfg.param_dtype)
    params_sh = tree_map(lambda s: sh(s.shape, s.axes), specs)

    if shape.kind == "train":
        state_abs = {"step": torch.empty((), dtype=torch.int32, device="meta"),
                     "params": params_abs,
                     "opt": _opt_abstract(cfg.optimizer, params_abs)}
        state_sh = {"step": None, "params": params_sh,
                    "opt": _opt_shardings(cfg.optimizer, specs, sharder)}
        batch_abs = inp.batch_specs(cfg, shape.global_batch, shape.seq_len,
                                    with_labels=True)
        batch_sh = _batch_shardings(cfg, batch_abs, sharder)
        fn = make_train_step(model, sharder, microbatches=microbatches,
                             accum_dtype=accum_dtype)
        return fn, (state_abs, batch_abs), (state_sh, batch_sh), (state_sh, None)

    if shape.kind == "prefill":
        batch_abs = inp.batch_specs(cfg, shape.global_batch, shape.seq_len,
                                    with_labels=False)
        batch_sh = _batch_shardings(cfg, batch_abs, sharder)
        fn = make_prefill_step(model, sharder)
        return fn, (params_abs, batch_abs), (params_sh, batch_sh), None

    if shape.kind == "decode":
        B = shape.global_batch
        cache_specs = model.cache_specs(B, shape.seq_len)
        cache_abs, tok_abs, pos_abs = inp.decode_specs(cfg, B, shape.seq_len)
        cache_sh = tree_map(lambda s: sh(s.shape, s.axes), cache_specs)
        tok_axes, pos_axes = inp.decode_axes(cfg)
        tok_sh = sh(tuple(tok_abs.shape), tok_axes)
        pos_sh = sh(tuple(pos_abs.shape), pos_axes)
        fn = make_serve_step(model, sharder)
        return (
            fn,
            (params_abs, cache_abs, tok_abs, pos_abs),
            (params_sh, cache_sh, tok_sh, pos_sh),
            (None, cache_sh),
        )

    raise ValueError(shape.kind)


# --------------------------------------------------------------------------- #
# the trace and its counters
# --------------------------------------------------------------------------- #
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _local_flops_counter(tally):
    """``FlopCounterMode`` counting only the ops on plain (local) tensors:
    an op on DTensors reaches the counter twice, as itself (global shapes)
    and as the op on the rank's shards, and only the second is this
    device's work; nothing while ``tally`` is paused (DTensor's own
    shape propagation)."""
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class LocalFlopCounter(FlopCounterMode):
        def _count_flops(self, func_packet, out, args, kwargs):
            if tally.paused or any(is_dtensor(a) for a in
                                   tree_flatten((args, kwargs))[0]):
                return out
            return super()._count_flops(func_packet, out, args, kwargs)

    return LocalFlopCounter(display=False)


def _tally_mode():
    """A dispatch mode over the local ops: bytes read and written, live
    storage (its peak), and each collective's kind, payload and group."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Tally(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self.seen: dict[int, int] = {}
            self.collectives: list[CollectiveOp] = []
            #: > 0 while DTensor propagates shapes on fake global-shaped
            #: stand-ins, which no device holds or runs
            self.paused = 0

        def _free(self, key: int) -> None:
            self.live -= self.seen.pop(key, 0)

        def track(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                return
            n = -(-st.nbytes() // _BLOCK) * _BLOCK
            self.seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, torch.distributed.tensor.DTensor) for t in types):
                return NotImplemented  # let DTensor lower it to local ops
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if self.paused:
                return out
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            for t in ins + outs:
                self.track(t)
            # an op that returns no tensor (prim.device, sizes) moves nothing
            if outs and not (func.is_view or func._overloadpacket in _NO_BYTES):
                self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind and func.namespace == "_c10d_functional" and outs:
                group = _resolve_process_group(args[-1])
                self.collectives.append(CollectiveOp(
                    kind, outs[0].numel() * outs[0].element_size(),
                    group.size(), str(outs[0].dtype).removeprefix("torch.")))
            return out

    return Tally()


_NO_BYTES = {torch.ops.aten.detach, torch.ops.aten.alias, torch.ops.aten.lift_fresh,
             torch.ops.aten.empty, torch.ops.aten.empty_strided,
             torch.ops.aten.sym_size, torch.ops.aten.sym_stride,
             torch.ops.aten.sym_numel, torch.ops.aten.sym_storage_offset}


@contextlib.contextmanager
def _strided_shards_off_fake():
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` builds an
    index tensor and reads it back (``tolist``); under ``FakeTensorMode``
    the tensor is fake and the read raises. The offsets are host
    arithmetic, so it runs with the fake mode set aside."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def offsets(*a, **k):
        with unset_fake_temporarily():
            return orig(*a, **k)

    cls.local_shard_size_and_offset = offsets
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def _propagation_untallied(tally):
    """DTensor works out an op's output shape by running the op on fake
    stand-ins of the GLOBAL shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``); in a fake world those ops reach
    the counters as if a device ran them. Pause the tally around it."""
    from torch.distributed.tensor import _sharding_prop

    cls = _sharding_prop.ShardingPropagator
    orig = getattr(cls, "_propagate_tensor_meta_non_cached", None)
    if orig is None:
        yield
        return

    def paused(self, *a, **k):
        tally.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            tally.paused -= 1

    cls._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        cls._propagate_tensor_meta_non_cached = orig


def _materialize(abstract, shardings, mesh):
    """Fake tensors for the stand-ins, distributed by their placements:
    each DTensor's local shard is a tensor of its own (as on a card, where
    a rank holds only its block), not a view of a global one."""
    if isinstance(abstract, dict):
        return {k: _materialize(abstract[k], None if shardings is None else
                                shardings[k], mesh) for k in abstract}
    if isinstance(abstract, (tuple, list)):
        return type(abstract)(_materialize(a, s, mesh)
                              for a, s in zip(abstract, shardings))
    if shardings is None:
        return torch.empty(abstract.shape, dtype=abstract.dtype, device="cpu")
    from torch.distributed.tensor import DTensor, Shard

    shape, coord = list(abstract.shape), mesh.get_coordinate()
    for i, p in enumerate(shardings):  # torch.chunk's split, as local_shard's
        if isinstance(p, Shard):
            step = -(-shape[p.dim] // mesh.size(i))
            shape[p.dim] = max(0, min(step, shape[p.dim] - coord[i] * step))
    local = torch.empty(shape, dtype=abstract.dtype, device="cpu")
    return DTensor.from_local(local, mesh, shardings, run_check=False,
                              shape=abstract.shape, stride=abstract.stride())


def _storages(tree) -> dict[int, int]:
    out = {}
    for leaf in tree_leaves_any(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if is_dtensor(leaf) else leaf
            st = t.untyped_storage()
            out[st._cdata] = -(-st.nbytes() // _BLOCK) * _BLOCK
    return out


def tree_leaves_any(tree) -> list:
    """Leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_any(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves_any(v)]
    return [tree]


@dataclasses.dataclass
class Traced:
    """The counts of one traced step, per device."""
    flops: float
    bytes: float
    collectives: list
    comm_counts: dict
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    trace_s: float


def _trace(cfg, shape, mesh, *, microbatches=1, rules=None,
           fsdp_gather=False, explicit_sp=False, accum_dtype="float32") -> Traced:
    """The counterpart of the JAX ``_compile``: trace the cell's step once
    on fake DTensors in the current (fake) world, counting as it runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args, in_sh, _ = build_cell(
        cfg, shape, mesh, microbatches=microbatches, rules=rules,
        fsdp_gather=fsdp_gather, explicit_sp=explicit_sp,
        accum_dtype=accum_dtype,
    )
    t0 = time.perf_counter()
    with FakeTensorMode(), implicit_replication(), _strided_shards_off_fake():
        placed = _materialize(args, in_sh, mesh)
        arg_st = _storages(placed)
        tally = _tally_mode()
        for leaf in tree_leaves_any(placed):
            tally.track(leaf.to_local() if is_dtensor(leaf) else leaf)
        flops, comm = _local_flops_counter(tally), CommDebugMode()
        with flops, comm, tally, _propagation_untallied(tally):
            out = fn(*placed)
        out_st = _storages(out)
        counts = {str(k).split(".")[-1]: int(v)
                  for k, v in comm.get_comm_counts().items()}
        alias = sum(n for k, n in out_st.items() if k in arg_st)
        result = Traced(
            flops=float(flops.get_total_flops()), bytes=float(tally.bytes),
            collectives=list(tally.collectives), comm_counts=counts,
            argument_bytes=sum(arg_st.values()),
            output_bytes=sum(n for k, n in out_st.items() if k not in arg_st),
            alias_bytes=alias, peak_bytes=tally.peak,
            trace_s=round(time.perf_counter() - t0, 2))
        del out, placed
    return result


def _cost(traced: Traced) -> dict:
    return {"flops": traced.flops, "bytes": traced.bytes}


def _memory(traced: Traced) -> dict:
    """JAX's keys. The step updates its state (train) or cache (decode) in
    place, so those outputs alias their arguments (``alias_bytes``);
    ``peak_bytes_est`` is the traced peak of live storage (the arguments
    included), ``temp_bytes`` what it holds above the arguments."""
    return {
        "argument_bytes": traced.argument_bytes,
        "output_bytes": traced.output_bytes,
        "temp_bytes": traced.peak_bytes - traced.argument_bytes,
        "alias_bytes": traced.alias_bytes,
        "peak_bytes_est": traced.peak_bytes,
        "hbm_capacity": int(HW["hbm_bytes"]),
    }


def collectives_summary(ops: list) -> dict:
    """``analysis/hlo.py collective_bytes_per_device``'s summary of a list
    of ``CollectiveOp``s (without its TPU-corrected total)."""
    by_kind: dict[str, dict] = {}
    total = 0.0
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "traffic_bytes": 0.0,
                                         "payload_bytes": 0})
        d["count"] += 1
        d["traffic_bytes"] += op.traffic_bytes
        d["payload_bytes"] += op.out_bytes
        total += op.traffic_bytes
    return {"total_traffic_bytes": total, "by_kind": by_kind, "n_ops": len(ops)}


# --------------------------------------------------------------------------- #
# probe decomposition (a check of the unrolled count)
# --------------------------------------------------------------------------- #
def probe_pair(cfg):
    """(cfgA, cfgB, multiplier): total = costA + multiplier x (costB - costA)."""
    if cfg.family == "moe":
        fk = cfg.first_k_dense
        a = dataclasses.replace(cfg, n_layers=fk + 1, scan_layers=False)
        b = dataclasses.replace(cfg, n_layers=fk + 2, scan_layers=False)
        return a, b, cfg.n_layers - fk - 1
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // 3
        tail = cfg.n_layers - 3 * n_super
        a = dataclasses.replace(cfg, n_layers=3 + tail, scan_layers=False)
        b = dataclasses.replace(cfg, n_layers=6 + tail, scan_layers=False)
        return a, b, n_super - 1
    a = dataclasses.replace(cfg, n_layers=1, scan_layers=False)
    b = dataclasses.replace(cfg, n_layers=2, scan_layers=False)
    return a, b, cfg.n_layers - 1


def _probe_costs(cfg, shape, mesh, *, microbatches=1, rules=None,
                 fsdp_gather=False, explicit_sp=False) -> dict:
    """The 1- and 2-layer probes, traced with the full step's microbatches
    (in torch the microbatch loop is unrolled too, so each probe counts
    its whole step), and the total they imply."""
    cfg_a, cfg_b, mult = probe_pair(cfg)
    out = {}
    for tag, c in (("A", cfg_a), ("B", cfg_b)):
        tr = _trace(c, shape, mesh, microbatches=microbatches, rules=rules,
                    fsdp_gather=fsdp_gather, explicit_sp=explicit_sp)
        coll = collectives_summary(tr.collectives)
        out[tag] = {"layers": c.n_layers, **_cost(tr),
                    "coll_traffic": coll["total_traffic_bytes"],
                    "coll_by_kind": coll["by_kind"], "trace_s": tr.trace_s}
    a, b = out["A"], out["B"]
    out["multiplier"] = mult
    out["derived"] = {
        "flops": a["flops"] + mult * (b["flops"] - a["flops"]),
        "bytes": a["bytes"] + mult * (b["bytes"] - a["bytes"]),
        "coll_traffic": a["coll_traffic"]
        + mult * (b["coll_traffic"] - a["coll_traffic"]),
        "per_layer_flops": b["flops"] - a["flops"],
        "per_layer_bytes": b["bytes"] - a["bytes"],
        "per_layer_coll": b["coll_traffic"] - a["coll_traffic"],
    }
    return out


# --------------------------------------------------------------------------- #
# cell runner
# --------------------------------------------------------------------------- #
#: production microbatch counts for the train shape (the JAX package's)
TRAIN_MICROBATCHES = {
    "qwen1_5_110b": 8,
    "smollm_360m": 8,
    "command_r_plus_104b": 8,
    "h2o_danube_3_4b": 8,
    "mamba2_2_7b": 8,
    "deepseek_moe_16b": 8,
    "grok_1_314b": 8,
    "recurrentgemma_9b": 8,
    "qwen2_vl_7b": 8,
    "hubert_xlarge": 8,
}


def _mesh_of(multi_pod: bool, debug_mesh: bool, mesh_shape):
    """(name, shape, axes) of the cell's mesh."""
    if mesh_shape is not None:
        shape, axes = mesh_shape
        return "x".join(map(str, shape)), tuple(shape), tuple(axes)
    if debug_mesh:
        return ("debug", *debug_shape(multi_pod=multi_pod))
    return ("2x16x16" if multi_pod else "16x16", *production_shape(multi_pod=multi_pod))


def run_cell(arch_id: str, shape_name, *, multi_pod: bool = False,
             probes: bool = True, debug_mesh: bool = False,
             microbatches: Optional[int] = None, rules: Optional[dict] = None,
             fsdp_gather: bool = False, remat: Optional[str] = None,
             explicit_sp: bool = False, param_dtype: Optional[str] = None,
             capacity_factor: Optional[float] = None,
             verbose: bool = True, cfg=None, mesh_shape=None) -> dict:
    """One cell, as the JAX ``run_cell``. ``shape_name`` may also be a
    ``ShapeConfig``, ``cfg`` replaces ``get_arch(arch_id)`` (a smoke
    config) and ``mesh_shape`` = (shape, axes) any mesh (a 1-card one)."""
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    cfg = cfg or get_arch(arch_id)
    if microbatches is None:
        microbatches = (TRAIN_MICROBATCHES.get(arch_id, 8)
                        if shape.kind == "train" else 1)
    if shape.kind in ("prefill", "decode"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")  # serving dtype
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)

    mesh_name, mshape, maxes = _mesh_of(multi_pod, debug_mesh, mesh_shape)
    result: dict[str, Any] = {
        "arch": arch_id,
        "arch_name": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "microbatches": microbatches,
        "fsdp_gather": fsdp_gather,
        "explicit_sp": explicit_sp,
        "remat": cfg.remat,
        "param_dtype": cfg.param_dtype,
    }

    ok, reason = cell_supported(cfg, shape)
    if not ok:
        result["status"] = "skip"
        result["reason"] = reason
        if verbose:
            print(f"[dryrun] SKIP {arch_id} x {shape.name}: {reason}")
        return result

    chips = math.prod(mshape)
    try:
        with fake_world(chips):
            mesh = make_mesh(mshape, maxes, device_type="cpu")
            kw = dict(microbatches=microbatches, rules=rules,
                      fsdp_gather=fsdp_gather, explicit_sp=explicit_sp)
            tr = _trace(cfg, shape, mesh, **kw)
            mem = _memory(tr)
            cost_full = _cost(tr)
            coll_full = collectives_summary(tr.collectives)
            result["full"] = {"trace_s": tr.trace_s, "memory": mem,
                              "cost_raw": cost_full, "collectives_raw": coll_full,
                              "comm_counts": tr.comm_counts,
                              "note": "layers and microbatches unrolled: the "
                                      "counts are the whole step's"}
            if verbose:
                print(f"[dryrun] {arch_id} x {shape.name} @ {mesh_name}: "
                      f"trace {tr.trace_s}s")
                print(f"  memory: {mem}")
                print(f"  cost: {cost_full}")
            terms = roofline_terms(
                flops_per_device=cost_full["flops"],
                bytes_per_device=cost_full["bytes"],
                coll_traffic_per_device=coll_full["total_traffic_bytes"],
                chips=chips,
                model_flops=model_flops_analytic(cfg, shape),
            )
            result["roofline"] = terms.as_dict()
            if probes:
                pr = _probe_costs(cfg, shape, mesh, **kw)
                pr["check"] = {"flops_full": cost_full["flops"],
                               "flops_derived": pr["derived"]["flops"],
                               "equal": pr["derived"]["flops"] == cost_full["flops"]}
                result["probes"] = pr
            if verbose:
                print(f"  roofline: compute={terms.compute_s:.4f}s "
                      f"memory={terms.memory_s:.4f}s "
                      f"collective={terms.collective_s:.4f}s "
                      f"dominant={terms.dominant} "
                      f"useful={terms.useful_flops_ratio:.2f} "
                      f"mfu_bound={terms.mfu_bound:.3f}")
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        result["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] ERROR {arch_id} x {shape.name}: {result['error'][:500]}")
    return result


def _out_path(outdir: str, r: dict) -> pathlib.Path:
    p = pathlib.Path(outdir)
    p.mkdir(parents=True, exist_ok=True)
    return p / f"{r['arch']}.{r['shape']}.{r['mesh']}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--fsdp-gather", action="store_true",
                    help="use-time FSDP weight gathering")
    ap.add_argument("--explicit-sp", action="store_true",
                    help="explicit sequence-parallel boundaries")
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--remat", choices=["none", "full", "dots"], default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                for mp in meshes:
                    cells.append((a, s, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    failures = 0
    for a, s, mp in cells:
        mesh_name = "debug" if args.debug_mesh else ("2x16x16" if mp else "16x16")
        path = pathlib.Path(args.out) / f"{a}.{s}.{mesh_name}.json"
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skip"):
                print(f"[dryrun] cached {a} x {s} @ {mesh_name}")
                continue
        r = run_cell(a, s, multi_pod=mp, probes=not args.no_probes,
                     debug_mesh=args.debug_mesh,
                     microbatches=args.microbatches,
                     fsdp_gather=args.fsdp_gather, remat=args.remat,
                     explicit_sp=args.explicit_sp,
                     param_dtype=args.param_dtype,
                     capacity_factor=args.capacity_factor)
        _out_path(args.out, r).write_text(json.dumps(r, indent=2, default=str))
        if r["status"] == "error":
            failures += 1
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
