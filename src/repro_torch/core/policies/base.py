"""Policy interface — the user-extensible part of USF.

The paper's pitch is that USF "enables users to implement their own process
scheduling algorithms without requiring special permissions"; this class is
that extension point. A policy only sees scheduling points; the Scheduler
enforces the framework invariants around it.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, AbstractSet, Optional

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.core.task import Job, Task


class StopReason(enum.Enum):
    BLOCK = "block"
    YIELD = "yield"
    DONE = "done"
    PREEMPT = "preempt"


class Policy:
    """Base policy. Subclasses override the queueing/picking logic."""

    name: str = "base"
    #: preemptive policies model the OS baseline; SCHED_COOP must keep False.
    preemptive: bool = False
    #: sim-engine tick granularity for preemptive policies (seconds).
    tick_interval: Optional[float] = None

    def __init__(self) -> None:
        self.sched: Optional["Scheduler"] = None

    # -- lifecycle ------------------------------------------------------ #
    def attach(self, sched: "Scheduler") -> None:
        self.sched = sched

    def on_job(self, job: "Job") -> None:
        """A job (process) registered with the scheduler."""

    def on_job_detach(self, job: "Job") -> None:
        """A job left this policy (arbiter detach, or a live re-home out
        of the *default* group — dedicated groups are dropped wholesale
        on swap/demote instead). The job's per-job queues are empty
        either way: a quiescent detach has no READY tasks by contract,
        and a live re-home withdraws them via ``remove`` first — but the
        job MAY still have RUNNING tasks on the live path, so only queue
        and per-task bookkeeping may be dropped here, never slot state."""

    # -- scheduling points ---------------------------------------------- #
    def on_ready(self, task: "Task") -> None:
        raise NotImplementedError

    def pick(self, slot_id: int) -> Optional["Task"]:
        raise NotImplementedError

    def on_run(self, task: "Task", slot_id: int, now: float) -> None:
        pass

    def on_stop(
        self, task: "Task", slot_id: int, now: float, elapsed: float, reason: StopReason
    ) -> None:
        pass

    def should_preempt(self, task: "Task", slot_id: int, now: float) -> bool:
        return False

    def slice_for(self, task: "Task") -> Optional[float]:
        """The running time after which ``should_preempt`` would evict
        ``task`` — i.e. the task's *effective* slice, which may be shorter
        than ``tick_interval`` (SCHED_FAIR divides the slice by weight).
        ``None`` means the task never slice-expires (non-preemptive
        policies). The real-thread runtime stamps this on the slot at
        dispatch so checkpoints can self-detect expiry without waiting for
        a watchdog tick (the fast preempt cycle)."""
        return self.tick_interval if self.preemptive else None

    # -- migration support (live job re-homing, arbiter attach) ---------- #
    def remove(self, task: "Task") -> None:
        """Detach a READY task from the pool without dispatching it.

        The inverse of ``on_ready``: after ``remove`` the task is no longer
        pickable here and all incremental pool accounting must be as if it
        had never been admitted. The arbiter uses this to surrender one
        job's queued tasks when the job re-homes to another policy group —
        every edge of the any↔any migration matrix (promotion, live policy
        swap, demotion) funnels through it, so it must stay correct under
        arbitrary withdraw-all/re-admit churn (locksteped against RefFair
        in tests/test_sched_fastpath.py).
        Raises ``KeyError`` if the task is not queued here.
        """
        raise NotImplementedError

    def pick_filtered(
        self, slot_id: int, allowed_jids: AbstractSet[int]
    ) -> Optional["Task"]:
        """Like ``pick`` but only tasks of jobs in ``allowed_jids`` may be
        returned. Used for per-job lease enforcement inside a shared group:
        the arbiter restricts the grant to under-lease member jobs while a
        sibling member is over its lease (the job-granular I5 analogue).
        """
        raise NotImplementedError

    # -- introspection --------------------------------------------------- #
    def ready_count(self) -> int:
        raise NotImplementedError

    def ready_count_of(self, job: "Job") -> int:
        """READY tasks of one job queued in this policy (job-filtered pick
        and migration support; policies keep this O(1))."""
        raise NotImplementedError

    def has_ready(self) -> bool:
        return self.ready_count() > 0
