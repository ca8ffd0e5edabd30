"""Policy A/B over one trace: replay the SAME workload under two
arbiter/policy configurations and diff the outcomes.

The workload fixes everything stochastic — arrivals, service demands,
deadlines, class mix — so the config under test is the ONLY independent
variable, the property the live benchmarks approximate with shared seeds
and the replayer gets by construction.

``run_ab`` returns raw per-side metrics (latency lists, miss/preempt
counts, makespan); percentile summarization/formatting lives in
``benchmarks/trace_replay.py`` (``src`` never imports ``benchmarks``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.trace.replayer import ReplayConfig, Replayer, ReplayResult, Workload


@dataclasses.dataclass
class SideMetrics:
    """One config's replay outcome, raw (no percentile math here)."""
    name: str
    config: ReplayConfig
    result: ReplayResult
    makespan: float
    latencies: list            # completed deadline-carrying tasks
    misses: int
    deadline_tasks: int
    completed: int
    preemptions: int
    urgent_grants: int
    events: int
    wall_s: float

    @property
    def miss_rate(self) -> float:
        return self.misses / self.deadline_tasks if self.deadline_tasks \
            else 0.0


def measure_side(name: str, workload: Workload, config: ReplayConfig,
                 *, until: Optional[float] = None) -> SideMetrics:
    """Replay ``workload`` under ``config`` and collect raw metrics.

    Latency of a deadline-carrying task = finish − arrival (the serving
    benchmarks' definition: the spec's arrival time is the request's
    arrival, the task's finish is the response)."""
    res = Replayer(workload, config).run(until=until)
    arrival_of = {}
    for spec, task in zip(workload.tasks, res.tasks):
        arrival_of[task.tid] = spec
    lats = []
    misses = 0
    deadline_tasks = 0
    completed = 0
    makespan = 0.0
    preemptions = 0
    for task in res.tasks:
        st = task.stats
        preemptions += st.preemptions
        fin = st.done_at
        if fin is None:
            continue
        completed += 1
        if fin > makespan:
            makespan = fin
        spec = arrival_of[task.tid]
        if spec.deadline is not None:
            deadline_tasks += 1
            lats.append(fin - spec.t)
            if fin > spec.deadline:
                misses += 1
    arb = res.sim.sched.arbiter
    return SideMetrics(
        name=name, config=config, result=res, makespan=makespan,
        latencies=lats, misses=misses, deadline_tasks=deadline_tasks,
        completed=completed, preemptions=preemptions,
        urgent_grants=getattr(arb, "urgent_grants", 0),
        events=res.events, wall_s=res.wall_s,
    )


def run_ab(workload: Workload, config_a: ReplayConfig,
           config_b: ReplayConfig, *, name_a: str = "a", name_b: str = "b",
           until: Optional[float] = None) -> dict:
    """Replay one workload under two configs; returns both sides plus the
    structural comparison (who won what, by how much)."""
    a = measure_side(name_a, workload, config_a, until=until)
    b = measure_side(name_b, workload, config_b, until=until)
    return {"a": a, "b": b, "comparison": compare_sides(a, b)}


def compare_sides(a: SideMetrics, b: SideMetrics) -> dict:
    def _ratio(x, y):
        return round(x / y, 4) if y else None

    return {
        "makespan_ratio": _ratio(a.makespan, b.makespan),
        "miss_rate": {a.name: round(a.miss_rate, 5),
                      b.name: round(b.miss_rate, 5)},
        "completed": {a.name: a.completed, b.name: b.completed},
        "preemptions": {a.name: a.preemptions, b.name: b.preemptions},
        "urgent_grants": {a.name: a.urgent_grants, b.name: b.urgent_grants},
        "events": {a.name: a.events, b.name: b.events},
    }


def slo_ab_configs(*, slots: int = 8, domains: int = 2) -> tuple:
    """The PR 7 SLO pair as replay configs: deadline-aware arbitration vs
    share-only, everything else identical (SCHED_FAIR 3 ms default)."""
    base = dict(slots=slots, domains=domains,
                default_policy=("SCHED_FAIR", 0.003), max_time=1e9)
    return (ReplayConfig(arbiter="deadline", **base),
            ReplayConfig(arbiter="none", **base))
