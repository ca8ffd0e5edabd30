"""Trace synthesis: arrival processes, workload generators, perturbations.

Everything here produces ``Workload`` objects (or plain arrival-time
lists) — no live engine objects — so a synthesized trace can be saved,
reloaded, perturbed and replayed under any ``ReplayConfig``. Pure
``random``/``math`` (no numpy in ``src/``); every generator is seeded and
deterministic.

Arrival processes:

* ``poisson_arrivals``  — homogeneous Poisson (exponential gaps)
* ``burst_arrivals``    — on/off modulated Poisson (MMPP-style bursts)
* ``diurnal_arrivals``  — sinusoid-modulated Poisson via thinning

Workloads:

* ``colocation_workload`` — the throughput trace: a latency job's request
  stream (n×chunks short computes) co-located with checkpoint-yielding
  batch ranks. Default shape is the benchmark's 10⁶-event trace.
* ``slo_workload``        — the open-arrival SLO cell of
  ``benchmarks/microservices.py`` rebuilt as a replayable workload
  (same node/shares/policies/service/classes), for the replayer-backed
  deadline-vs-share A/B at 10⁵+ requests per cell.

Perturbations (model straggler/churn studies from cluster traces):

* ``with_stragglers`` — scale a random task subset's compute times
* ``with_node_churn`` — timed width changes (slot parking) on the node
"""

from __future__ import annotations

import math
import random
from typing import Iterable, Optional

from repro_torch.trace.replayer import JobSpec, TaskSpec, Workload

__all__ = [
    "poisson_arrivals",
    "burst_arrivals",
    "diurnal_arrivals",
    "colocation_workload",
    "slo_workload",
    "with_stragglers",
    "with_node_churn",
    "SLO_SLOTS",
    "SLO_SERVE_SHARE",
    "SLO_BATCH_SHARE",
    "SLO_SERVICE_S",
    "SLO_CHUNK_S",
    "SLO_BATCH_CHUNK_S",
    "SLO_CLASSES",
]


# --------------------------------------------------------------------- #
# arrival processes
# --------------------------------------------------------------------- #
def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     start: float = 0.05) -> list[float]:
    """``n`` homogeneous-Poisson arrival times at ``rate``/s."""
    rng = random.Random(seed)
    expo = rng.expovariate
    t = start
    out = []
    for _ in range(n):
        t += expo(rate)
        out.append(t)
    return out


def burst_arrivals(rate: float, n: int, *, burst_factor: float = 8.0,
                   burst_frac: float = 0.1, period: float = 2.0,
                   seed: int = 0, start: float = 0.05) -> list[float]:
    """On/off modulated Poisson: within each ``period``, a ``burst_frac``
    window runs at ``burst_factor``× the base rate (the base rate is
    scaled down so the long-run mean stays ``rate``)."""
    if not 0.0 < burst_frac < 1.0:
        raise ValueError("burst_frac must be in (0, 1)")
    # mean = base * (1 - frac + frac * factor)  ==  rate
    base = rate / (1.0 - burst_frac + burst_frac * burst_factor)
    rng = random.Random(seed)
    expo = rng.expovariate
    t = start
    out = []
    for _ in range(n):
        phase = (t % period) / period
        r = base * burst_factor if phase < burst_frac else base
        t += expo(r)
        out.append(t)
    return out


def diurnal_arrivals(rate: float, n: int, *, period: float = 60.0,
                     depth: float = 0.8, seed: int = 0,
                     start: float = 0.05) -> list[float]:
    """Sinusoid-modulated Poisson (peak-to-trough swing ``depth``) via
    Lewis thinning: candidates at the peak rate, accepted with
    probability λ(t)/λ_peak. ``rate`` is the long-run mean."""
    if not 0.0 <= depth <= 1.0:
        raise ValueError("depth must be in [0, 1]")
    peak = rate * (1.0 + depth)
    rng = random.Random(seed)
    expo, unif = rng.expovariate, rng.random
    two_pi = 2.0 * math.pi / period
    t = start
    out = []
    while len(out) < n:
        t += expo(peak)
        lam = rate * (1.0 + depth * math.sin(two_pi * t))
        if unif() * peak <= lam:
            out.append(t)
    return out


# --------------------------------------------------------------------- #
# workload generators
# --------------------------------------------------------------------- #
def colocation_workload(*, n_requests: int = 30_000, chunks: int = 40,
                        chunk_s: float = 0.0005, rate: float = 250.0,
                        batch_tasks: int = 8, batch_segments: int = 12_000,
                        batch_chunk_s: float = 0.001,
                        yield_every: int = 100, seed: int = 0,
                        arrivals: Optional[list] = None) -> Workload:
    """The replay-throughput trace: a serve job's Poisson request stream
    (each request = ``chunks`` short computes) co-located with long
    checkpoint-yielding batch ranks. Defaults synthesize ≈1.36×10⁶
    engine events under the default SCHED_COOP config at ≈0.6 serve
    load on 8 slots (batch ranks borrow the rest — the node is full)."""
    if arrivals is None:
        arrivals = poisson_arrivals(rate, n_requests, seed=seed)
    serve, batch = JobSpec(0, "serve"), JobSpec(1, "batch")
    req_ops = ("compute", chunk_s, 0.0)
    request = tuple([req_ops] * chunks)
    seg = [("compute", batch_chunk_s, 0.0), ("checkpoint",)]
    batch_ops = []
    for i in range(batch_segments):
        batch_ops.extend(seg)
        if yield_every and (i + 1) % yield_every == 0:
            batch_ops.append(("yield",))
    batch_ops = tuple(batch_ops)

    tasks = [TaskSpec(0.0, i, 1, None, 0.0, batch_ops)
             for i in range(batch_tasks)]
    tasks.extend(
        TaskSpec(t, batch_tasks + i, 0, None, chunks * chunk_s, request)
        for i, t in enumerate(arrivals)
    )
    tasks.sort(key=lambda ts: ts.t)
    return Workload(
        jobs=[serve, batch], tasks=tasks,
        meta={"generator": "colocation", "n_requests": n_requests,
              "chunks": chunks, "chunk_s": chunk_s, "rate": rate,
              "batch_tasks": batch_tasks, "batch_segments": batch_segments,
              "seed": seed},
    )


# The open-arrival SLO cell (benchmarks/microservices.py), as data. Same
# node, shares, policies, service demand and request classes — only the
# arrival RNG differs (stdlib random here vs numpy there), which moves
# individual samples but not the distributions the A/B compares.
SLO_SLOTS = 8
SLO_SERVE_SHARE = 4.0
SLO_BATCH_SHARE = 4.0
SLO_SERVICE_S = 0.008
SLO_CHUNK_S = 0.001
SLO_BATCH_CHUNK_S = 0.005
SLO_CLASSES = [("tight", 0.030, 0.5), ("loose", 0.400, 0.5)]


def slo_workload(load: float, *, n_requests: int = 800,
                 seed: int = 0) -> Workload:
    """One offered-load cell of the SLO sweep as a replayable workload:
    Poisson arrivals at ``load × serve-share / service_s`` into a
    dedicated-policy serve job (every request carries an absolute
    deadline drawn from the tight/loose class mix) plus slot-hungry
    batch ranks running to the arrival horizon. Replay it under
    ``ReplayConfig(arbiter="deadline")`` vs ``"none"`` for the A/B."""
    rate = load * SLO_SERVE_SHARE / SLO_SERVICE_S
    arrivals = poisson_arrivals(rate, n_requests, seed=seed)
    rng = random.Random(seed + 1)
    horizon = arrivals[-1] + 2.0

    serve = JobSpec(0, "serve", share=SLO_SERVE_SHARE,
                    policy=("SCHED_FAIR", 0.003))
    batch = JobSpec(1, "batch", share=SLO_BATCH_SHARE,
                    policy=("SCHED_FAIR", 0.020))

    n_chunks = max(1, round(SLO_SERVICE_S / SLO_CHUNK_S))
    request = tuple([("compute", SLO_CHUNK_S, 0.0)] * n_chunks)

    # batch ranks: the live bench loops `while now < horizon`; the data
    # equivalent is a fixed segment count covering the horizon on a
    # dedicated slot (extra segments just keep borrowing idle slots)
    n_seg = int(math.ceil(horizon / SLO_BATCH_CHUNK_S))
    batch_ops = tuple([("compute", SLO_BATCH_CHUNK_S, 0.0),
                       ("checkpoint",)] * n_seg)
    tasks = [TaskSpec(0.0, i, 1, None, 0.0, batch_ops)
             for i in range(SLO_SLOTS)]

    weights = [w for _, _, w in SLO_CLASSES]
    classes = rng.choices(range(len(SLO_CLASSES)), weights=weights,
                          k=n_requests)
    for i, arr in enumerate(arrivals):
        cname, slo, _ = SLO_CLASSES[classes[i]]
        tasks.append(TaskSpec(arr, SLO_SLOTS + i, 0, arr + slo,
                              SLO_SERVICE_S, request))
    tasks.sort(key=lambda ts: ts.t)
    return Workload(
        jobs=[serve, batch], tasks=tasks,
        meta={"generator": "slo", "load": load, "rate_rps": round(rate, 2),
              "n_requests": n_requests, "seed": seed, "horizon": horizon,
              "classes": [{"name": n, "slo_s": s, "weight": w}
                          for n, s, w in SLO_CLASSES],
              "class_of": classes},
    )


# --------------------------------------------------------------------- #
# perturbations
# --------------------------------------------------------------------- #
def with_stragglers(workload: Workload, *, frac: float = 0.05,
                    factor: float = 4.0, seed: int = 0,
                    jid: Optional[int] = None) -> Workload:
    """A straggler study: scale every compute/stall duration of a random
    ``frac`` of tasks (optionally restricted to job ``jid``) by
    ``factor``. Returns a new Workload; the input is untouched."""
    rng = random.Random(seed)
    tasks = []
    slowed = 0
    for ts in workload.tasks:
        eligible = jid is None or ts.jid == jid
        if eligible and rng.random() < frac:
            ops = tuple(
                (op[0], op[1] * factor) + op[2:]
                if op[0] in ("compute", "stall") else op
                for op in ts.ops
            )
            hint = (ts.cost_hint * factor
                    if ts.cost_hint else ts.cost_hint)
            tasks.append(TaskSpec(ts.t, ts.tid, ts.jid, ts.deadline,
                                  hint, ops))
            slowed += 1
        else:
            tasks.append(ts)
    meta = dict(workload.meta)
    meta["stragglers"] = {"frac": frac, "factor": factor, "seed": seed,
                          "slowed": slowed}
    return Workload(jobs=list(workload.jobs), tasks=tasks,
                    control=list(workload.control), meta=meta)


def with_node_churn(workload: Workload,
                    events: Iterable[tuple]) -> Workload:
    """Overlay node-churn: ``events`` is ``(time, width)`` pairs — the
    node's effective slot count at each time (``None`` = full width).
    Replayed as elastic slot parking (``set_slot_target``), the
    engine-level analogue of nodes leaving/rejoining the cluster."""
    control = list(workload.control)
    churn = [(float(t), "target", w, None) for (t, w) in events]
    control.extend(churn)
    control.sort(key=lambda c: c[0])
    meta = dict(workload.meta)
    meta["node_churn"] = [[t, w] for (t, w) in events]
    return Workload(jobs=list(workload.jobs), tasks=list(workload.tasks),
                    control=control, meta=meta)
