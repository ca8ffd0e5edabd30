"""Elastic rescale: continue a run on a different mesh (node failures or
reclaimed capacity), the job-level generalization of cooperative yield.
Port of ``repro/launch/elastic.py``.

The checkpoint format is mesh-agnostic (host arrays); rescaling = restore
with the NEW mesh's placements (``ckpt.restore_checkpoint(...,
shardings=, mesh=)``) and re-trace the step. The dry-run demonstration
traces the same arch on (16,16) and on a degraded (8,16) mesh (128
survivors), each in a fake world of its size, with the same state tree.

Device reclaim and slot reclaim share one path: each mesh transition is
emitted as a ``launch/rescale.py MeshRescaleEvent``, and an optional
``ElasticCoordinator`` applies it to registered jobs' slot leases
(``SlotLease.resize``): a job that loses half its devices surrenders the
matching fraction of its CPU-side slot share to co-located siblings.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.elastic --arch smollm_360m
"""

from __future__ import annotations

import argparse
import math

from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch, list_archs
from repro_torch.launch.dryrun import _memory, _trace
from repro_torch.launch.mesh import fake_world, make_mesh

#: the meshes of the demonstration: the full pod and its degraded half
MESHES = (("full_16x16", (16, 16)), ("degraded_8x16", (8, 16)))


def elastic_demo(arch_id: str, shape_name="train_4k",
                 verbose: bool = True, coordinator=None, *, cfg=None,
                 microbatches: int = 8, meshes=MESHES) -> dict:
    """Trace on the full and degraded meshes; with a ``coordinator``
    (``launch/rescale.py ElasticCoordinator``) every mesh transition is
    also applied to the registered jobs' slot leases, so the scheduler-side
    share shrinks in step with the device-side capacity. ``shape_name`` may
    be a ``ShapeConfig`` and ``cfg`` replaces ``get_arch(arch_id)``."""
    from repro_torch.launch.rescale import MeshRescaleEvent

    cfg = cfg or get_arch(arch_id)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    results = {}
    prev_shape = None
    for name, mesh_shape in meshes:
        with fake_world(math.prod(mesh_shape)):
            mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
            traced = _trace(cfg, shape, mesh, microbatches=microbatches)
        mem = _memory(traced)
        results[name] = {"trace_s": traced.trace_s, "memory": mem,
                         "flops": traced.flops}
        if verbose:
            print(f"[elastic] {arch_id} {shape.name} on {name}: "
                  f"trace {traced.trace_s}s, "
                  f"peak {mem['peak_bytes_est']/2**30:.2f} GiB/card")
        if coordinator is not None and prev_shape is not None:
            event = MeshRescaleEvent(prev_shape, mesh_shape)
            shares = coordinator.on_rescale(event)
            results[name]["lease_shares"] = shares
            if verbose:
                print(f"[elastic] rescale {event.old_devices}->"
                      f"{event.new_devices} devices: slot leases resized "
                      f"to {shares}")
        prev_shape = mesh_shape
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    args = ap.parse_args()
    elastic_demo(args.arch, args.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
