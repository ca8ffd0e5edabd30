"""System-wide scheduling statistics.

These counters are what the paper's evaluation plots are made of:
throughput (tasks or work units / s), latency distributions, preemption and
migration counts, slot busy fraction, spin (busy-wait) waste.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.task import Task


@dataclasses.dataclass
class SchedStats:
    makespan: float = 0.0
    tasks_completed: int = 0
    total_run_time: float = 0.0
    total_wait_time: float = 0.0
    total_blocked_time: float = 0.0
    total_spin_time: float = 0.0
    dispatches: int = 0
    migrations: int = 0
    cross_domain_migrations: int = 0
    preemptions: int = 0
    yields: int = 0
    context_switch_time: float = 0.0
    n_slots: int = 0

    @property
    def slot_busy_fraction(self) -> float:
        """run_time already includes spin intervals (a spinning task is
        RUNNING and holds its slot)."""
        cap = self.makespan * max(self.n_slots, 1)
        return self.total_run_time / cap if cap else 0.0

    @property
    def useful_fraction(self) -> float:
        """Fraction of slot capacity doing *useful* (non-spin) work."""
        cap = self.makespan * max(self.n_slots, 1)
        return (self.total_run_time - self.total_spin_time) / cap if cap else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["slot_busy_fraction"] = self.slot_busy_fraction
        d["useful_fraction"] = self.useful_fraction
        return d


def collect(tasks: Iterable["Task"], *, makespan: float, n_slots: int) -> SchedStats:
    s = SchedStats(makespan=makespan, n_slots=n_slots)
    for t in tasks:
        st = t.stats
        s.tasks_completed += int(t.done)
        s.total_run_time += st.run_time
        s.total_wait_time += st.wait_time
        s.total_blocked_time += st.blocked_time
        s.total_spin_time += st.spin_time
        s.dispatches += st.dispatches
        s.migrations += st.migrations
        s.cross_domain_migrations += st.cross_domain_migrations
        s.preemptions += st.preemptions
        s.yields += st.yields
    return s


def latency_summary(latencies: list[float]) -> dict:
    """Mean / p50 / p95 / p99 / p999 / max — what Fig. 4 reports per
    request (p999 is what an SLO sweep's tail story hinges on)."""
    if not latencies:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "p999": 0.0, "max": 0.0}
    xs = sorted(latencies)

    def pct(p: float) -> float:
        i = min(len(xs) - 1, max(0, int(round(p * (len(xs) - 1)))))
        return xs[i]

    return {
        "n": len(xs),
        "mean": statistics.fmean(xs),
        "p50": pct(0.50),
        "p95": pct(0.95),
        "p99": pct(0.99),
        "p999": pct(0.999),
        "max": xs[-1],
    }
