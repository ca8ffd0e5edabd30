"""GPipe-style pipeline parallelism over a ``pipe`` mesh dimension (or a
process group). Port of ``repro/runtime/pipeline.py``.

Not used by the assigned cells (DP x FSDP x TP suffices at 256-512
cards), but the largest configs at 1000+ cards want a ``pipe`` axis; this
module provides the schedule.

Each rank holds ONE stage's parameters (the JAX function takes them
stacked ``[n_stages, ...]`` and shard_maps the stack; here the stack never
exists). The schedule is the JAX one: ``n_micro + n_stages - 1`` ticks
(the GPipe fill/drain bubble); rank 0 injects microbatch t at tick t,
rank r computes on ticks r..r+n_micro-1, activations move rank r -> r+1,
and the last rank records its completed microbatches. Where JAX rotates
with ``ppermute`` every tick, an inactive rank here sends and computes
nothing.

Transport (``transport``): "device" sends the activation tensors as they
are; "host" hands them off through host memory, for a group whose backend
cannot send tensors of their device (gloo moves CUDA tensors only in
all_reduce and broadcast). It is chosen from the group's backend and the
tensors' device, never by catching an error.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    """The process group of ``axis`` of a DeviceMesh, or ``mesh`` itself
    (a ProcessGroup, or None for the world)."""
    if hasattr(mesh, "get_group") and hasattr(mesh, "mesh_dim_names"):
        return mesh.get_group(axis)
    return mesh


def transport(group, device: torch.device) -> str:
    """"host" where ``group``'s backend has no send/recv for tensors on
    ``device`` (gloo with CUDA tensors), else "device"."""
    backend = str(dist.get_backend(group)).lower()
    return "host" if device.type == "cuda" and "gloo" in backend else "device"


def gpipe_forward(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,           # this rank's stage
    microbatches: torch.Tensor,  # [n_micro, mb, ...] (rank 0's are read)
    *,
    axis: str = "pipe",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Runs ``y = stage_{n-1}(...stage_0(x))`` for every microbatch with the
    GPipe schedule over the ranks of ``axis`` of ``mesh`` (a DeviceMesh; or
    a ProcessGroup, None for the world). ``stage_fn`` keeps the shape.
    Returns the last stage's ``[n_micro, mb, ...]`` on every rank.

    ``stats``, if given, receives the ticks, the transport, and this
    rank's busy seconds in ``stage_fn`` (device-synchronised) and wall
    seconds."""
    group = _group(mesh, axis)
    n_stages = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_micro = microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    dev = microbatches.device
    how = transport(group, dev)
    peer = lambda r: dist.get_global_rank(group, r) if group is not None else r
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    def host(t):
        return t.to("cpu", copy=True) if how == "host" else t

    outs = torch.empty_like(microbatches)
    pending = []
    busy = 0.0
    t_start = time.perf_counter()
    for t in range(ticks):
        j = t - rank                      # the microbatch this rank holds
        if not 0 <= j < n_micro:
            continue                      # fill or drain: idle this tick
        if rank == 0:
            x = microbatches[j]
        else:
            buf = host(torch.empty_like(microbatches[0]))
            dist.recv(buf, src=peer(rank - 1), group=group)
            x = buf.to(dev)
        if stats is not None:
            sync()
            t0 = time.perf_counter()
        y = stage_fn(stage_params, x)
        if stats is not None:
            sync()
            busy += time.perf_counter() - t0
        if rank == n_stages - 1:
            outs[j] = y
        else:
            send = host(y.contiguous())
            pending.append((dist.isend(send, dst=peer(rank + 1), group=group), send))
    for work, _ in pending:
        work.wait()
    result = host(outs)
    dist.broadcast(result, src=peer(n_stages - 1), group=group)
    if stats is not None:
        sync()
        stats.update(ticks=ticks, transport=how, busy_s=busy,
                     wall_s=time.perf_counter() - t_start)
    return result.to(dev)
