"""Nested-runtime matmul (paper §5.3) — REAL threads + REAL torch compute.

The twin of ``examples/nested_runtime_matmul.py`` on the port. An outer
"runtime" of worker threads each calls an inner parallel BLAS-like region
(blocked matmuls with a busy-wait team barrier). All threads are gated by
USF: with SCHED_COOP only `slots` threads run at once, swapping at
blocking points; with --free the Linux scheduler multiplexes everything.

Each team member computes ``a @ a`` (a plain ``torch.matmul``, as the
example's ``jax.jit(lambda x: x @ x)``) and waits for it: a synchronize of
the current stream on the CUDA card (default; ``--device cpu`` otherwise),
as ``block_until_ready`` does.

Run:  PYTHONPATH=src python -m repro_torch.examples.nested_runtime_matmul [--free] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.policies import SchedCoop
from repro_torch.core.sync import BusyWaitBarrier, CoopChannel
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.models.base import resolve_device

N = 256          # block size
N_BLOCKS = 12    # outer tasks
INNER = 3        # inner team width
SLOTS = 2        # "cores"


def run(*, free: bool = False, n: int = N, device=None, verbose: bool = True) -> dict:
    """The example, end to end, on ``n`` x ``n`` fp32 blocks of ones
    (``device=None``: the CUDA card). Returns the wall seconds, the
    runtime's ``stats``, the number of products and whether every one was
    exactly ``n`` x ones."""
    dev = resolve_device(device)
    usf = UsfRuntime(Topology(SLOTS, 1), SchedCoop(), gating=not free)
    job = Job("matmul")
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    exact = []  # one device bool a product, read once all are done

    def mm():
        p = a @ a
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        exact.append(torch.equal(p, torch.full_like(p, n)) if dev.type == "cpu"
                     else (p == n).all())

    mm()  # warm up once (the example compiles here)
    exact.clear()

    work = CoopChannel(usf)
    for i in range(N_BLOCKS):
        work.put(i)
    for _ in range(SLOTS):
        work.put(None)

    def outer_worker():
        while True:
            item = work.get()
            if item is None:
                return
            bar = BusyWaitBarrier(usf, INNER, yield_every=1)
            members = [
                usf.create(lambda b=bar: (mm(), b.wait(max_spins=2_000_000)),
                           job=job, name=f"team{item}")
                for _ in range(INNER - 1)
            ]
            mm()
            bar.wait(max_spins=2_000_000)
            for m in members:
                usf.join(m)

    try:
        t0 = time.monotonic()
        workers = [usf.create(outer_worker, job=job, name=f"outer{i}")
                   for i in range(SLOTS)]
        for w in workers:
            assert usf.join(w, timeout=300.0)
        dt = time.monotonic() - t0
        s = usf.stats()
    finally:
        usf.shutdown()
    mode = "free (Linux)" if free else "SCHED_COOP"
    if verbose:
        print(f"{mode}: {N_BLOCKS} blocks x {INNER}-thread teams on {SLOTS} "
              f"slots in {dt:.2f}s; dispatches={s['dispatches']} "
              f"cache_hits={s['cache_hits']} yields={s['yields']}")
    return {"mode": mode, "wall_s": dt, "stats": s, "products": len(exact),
            "exact": all(bool(e) for e in exact)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--free", action="store_true",
                    help="Linux-baseline mode (no USF gating)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(free=args.free, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
