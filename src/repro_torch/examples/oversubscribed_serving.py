"""Oversubscribed multi-model serving (paper §5.5) — REAL torch inference.

The twin of ``examples/oversubscribed_serving.py`` on the port. Three
model servers (different architectures) + a gateway share a 2-slot USF
runtime. Clients fan requests through the gateway; every wait (request
queue, batch formation, device step) is a USF blocking point. Servers
start through the default group and are re-homed LIVE into their own
lease groups (no drain).

Phase 2 demos preemptive co-location on real threads: a CPU-bound
SCHED_FAIR batch job shares the node under its own lease — the watchdog
tick driver time-slices it at ``usf.checkpoint()`` preemption points and a
mid-run ``lease.resize()`` reclaims its slots within a tick period, while
the SCHED_COOP servers take zero preemptions (I2 per job).

The servers run on the CUDA card (decode attention through K1, the MoE
experts through K3) unless ``--device cpu`` is given; ``configs`` and
``params`` replace the smoke configs and their seeded weights.

Run:  PYTHONPATH=src python -m repro_torch.examples.oversubscribed_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop, SchedFair
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.models.base import resolve_device
from repro_torch.serve.engine import Gateway, InferenceServer

#: the example's servers: (name, architecture)
SERVERS = (("llama-ish", "smollm_360m"), ("moe-ish", "deepseek_moe_16b"),
           ("ssm-ish", "mamba2_2_7b"))
#: the fan-out clients' prompts and new tokens; phase 2's two fan-outs
PROMPTS = [[1 + i, 2 + i, 3 + i] for i in range(6)]
MAX_NEW = 4
PHASE2_PROMPTS = ([5, 6, 7], [8, 9, 10])
PHASE2_MAX_NEW = 2


def preemptive_colocation_demo(usf, servers, gw, *, verbose=True) -> dict:
    """Phase 2: a preemptive batch job co-located with the live servers."""
    batch = Job("batch-analytics")
    lease = usf.attach(batch, policy=SchedFair(slice_s=0.02), share=600.0)
    stop = threading.Event()

    def crunch():
        n = 0
        while not stop.is_set():  # CPU-bound: never blocks voluntarily
            n += 1
            if n % 2000 == 0:
                usf.checkpoint()  # the only preemption points it has

    workers = [usf.create(crunch, job=batch, name=f"batch{i}")
               for i in range(3)]
    try:
        r1 = gw.handle(list(PHASE2_PROMPTS[0]), max_new=PHASE2_MAX_NEW, timeout=300.0)
        lease.resize(60.0)  # elastic reclaim: hand slots back to the servers
        r2 = gw.handle(list(PHASE2_PROMPTS[1]), max_new=PHASE2_MAX_NEW, timeout=300.0)
    finally:
        stop.set()
    for w in workers:
        assert usf.join(w, timeout=30.0)
    batch_preempts = sum(t.stats.preemptions for t in batch.tasks)
    coop_preempts = sum(
        sum(t.stats.preemptions for t in s.job.tasks) for s in servers
    )
    if verbose:
        print(f"phase 2 (preemptive co-location on real threads):")
        print(f"  fan-out latency with batch job pinned: {r1['latency']*1e3:.0f}ms,"
              f" after lease.resize reclaim: {r2['latency']*1e3:.0f}ms")
        print(f"  batch preemptions={batch_preempts} (watchdog-delivered), "
              f"coop-server preemptions={coop_preempts} (I2: must be 0)")
        print(f"  watchdog ticks={usf.watchdog.ticks_fired}, "
              f"preempt requests={usf.watchdog.preempts_requested}")
    assert coop_preempts == 0
    usf.detach(batch)
    return {"requests": [r1, r2], "latency_pinned_s": r1["latency"],
            "latency_after_resize_s": r2["latency"],
            "batch_preempts": batch_preempts, "coop_preempts": coop_preempts,
            "watchdog_ticks": usf.watchdog.ticks_fired,
            "preempt_requests": usf.watchdog.preempts_requested}


def run(configs: Optional[dict] = None, *, device=None,
        params: Optional[dict] = None, verbose: bool = True) -> dict:
    """The example, end to end. ``configs`` maps each server's name to its
    config (default: the smoke configs of ``SERVERS``), ``params`` a name
    to its param tree on ``device`` (default: each server's seeded draw);
    ``device=None`` is the CUDA card.

    Returns the phase-1 requests in client order (``requests``: prompt,
    latency, per-server outputs), wall seconds, latency p50 and max, and
    per server ``served`` and engine ``steps``; ``phase2`` holds the
    co-location demo's two fan-outs, preemption counts and watchdog ticks."""
    dev = resolve_device(device)
    configs = configs or {name: get_smoke(arch) for name, arch in SERVERS}
    params = params or {}
    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        servers = [
            InferenceServer(name, cfg, usf, max_batch=2, max_len=48, nice=10,
                            device=dev, params=params.get(name))
            for name, cfg in configs.items()
        ]
        for s in servers:
            s.start()
        gw = Gateway(usf, servers)

        results: list[Optional[dict]] = [None] * len(PROMPTS)

        def client(i):
            results[i] = gw.handle(PROMPTS[i], max_new=MAX_NEW)

        t0 = time.monotonic()
        clients = [
            usf.create(lambda i=i: client(i), job=gw.job, name=f"client{i}")
            for i in range(len(PROMPTS))
        ]
        for c in clients:
            ok = usf.join(c, timeout=300.0)
            assert ok, "request timed out"
        dt = time.monotonic() - t0

        lats = sorted(r["latency"] for r in gw.responses)
        if verbose:
            print(f"served {len(gw.responses)} fan-out requests over "
                  f"{len(servers)} models in {dt:.1f}s on 2 slots")
            print(f"latency p50={lats[len(lats) // 2] * 1e3:.0f}ms "
                  f"max={lats[-1] * 1e3:.0f}ms")

        phase2 = preemptive_colocation_demo(usf, servers, gw, verbose=verbose)

        for s in servers:
            if verbose:
                print(f"  {s.name}: served={s.served}")
            s.stop()
    finally:
        usf.shutdown()
    return {"requests": [dict(r, prompt=p) for r, p in zip(results, PROMPTS)],
            "wall_s": dt, "latency_p50_s": lats[len(lats) // 2],
            "latency_max_s": lats[-1],
            "served": {s.name: s.served for s in servers},
            "steps": {s.name: s.steps for s in servers}, "phase2": phase2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
