"""Device meshes: the JAX package's production and debug meshes as
``torch.distributed`` ``DeviceMesh``es.

Defined as FUNCTIONS (not module-level constants) so importing this module
touches no distributed state.

Single pod: (data=16, model=16) = 256 cards.
Multi-pod:  (pod=2, data=16, model=16) = 512 cards; the ``pod`` axis is
pure data parallelism (gradient all-reduce only). On H100 nodes of eight
cards a 16-way ``model`` axis spans two NVLink domains.

A mesh needs a process group of its size. A mesh larger than the host
lives in a **fake world** (``fake_world``): ``torch.distributed``'s
``fake`` backend, in which this process is rank 0 of ``n`` and every
collective returns at once without moving data: the counterpart of the
JAX package's ``--xla_force_host_platform_device_count``. The dry run
traces a step there under ``FakeTensorMode``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch.distributed as dist


def _fake_store():
    """``FakeStore``, the in-process store the ``fake`` backend pairs with.
    It lives in ``torch.testing._internal.distributed.fake_pg``, which is
    internal to torch (no stable API); a torch without it cannot host a
    fake world, and this raises rather than falling back to anything."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the torch build
        raise RuntimeError(
            "this torch has no torch.testing._internal.distributed.fake_pg."
            "FakeStore, so it cannot start a fake world (the dry run needs "
            "one)") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A world of ``n`` fake ranks, this process rank 0, for the block: it
    starts the ``fake`` process group and tears it down on exit. Refuses
    to stack on a process group that is already up."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; a fake "
                           "world needs its own")
    dist.init_process_group("fake", rank=0, world_size=n, store=_fake_store())
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current world
    (whose size must be the mesh's). ``device_type`` "cpu" for a traced
    (fake) or gloo-on-CPU world."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def debug_shape(*, multi_pod: bool = False):
    """(shape, axes) of the debug mesh (8 / 16 ranks)."""
    if multi_pod:
        return (2, 2, 4), ("pod", "data", "model")
    return (2, 4), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod=multi_pod),
                     device_type=device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Tiny meshes for fast local iteration (8/16 ranks)."""
    return make_mesh(*debug_shape(multi_pod=multi_pod), device_type=device_type)
