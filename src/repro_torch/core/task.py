"""Tasks and jobs.

Paper mapping: a ``Task`` is a pthread recruited as a nOS-V worker+task
(glibcv converts every pthread into exactly one task bound to one worker);
a ``Job`` is a process registered in the shared nOS-V instance.

TPU mapping: a ``Task`` is a unit of device work (training micro-step,
serving request phase, checkpoint flush); a ``Job`` is a training run or a
model server sharing the pod.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Optional

_TID = itertools.count()
_JID = itertools.count()


class TaskState(enum.Enum):
    CREATED = "created"
    READY = "ready"        # queued in the scheduler, not running
    RUNNING = "running"    # the unique running task of some slot
    BLOCKED = "blocked"    # parked on a sync object / wait
    DONE = "done"


@dataclasses.dataclass(slots=True)
class TaskStats:
    """Per-task accounting (feeds SchedStats and the benchmarks)."""

    created_at: float = 0.0
    first_run_at: Optional[float] = None
    done_at: Optional[float] = None
    run_time: float = 0.0          # time actually executing on a slot
    wait_time: float = 0.0         # READY time spent queued
    blocked_time: float = 0.0      # BLOCKED time
    spin_time: float = 0.0         # busy-wait time (consumes a slot!)
    dispatches: int = 0            # times resumed onto a slot
    migrations: int = 0            # resumed on a different slot than last time
    cross_domain_migrations: int = 0
    preemptions: int = 0           # involuntary (preemptive policies only)
    yields: int = 0                # voluntary


class Job:
    """A process in the paper; a co-located training/serving job here.

    ``nice`` mirrors the paper's microservices setup (gateway nice 0 vs
    server nice 20); SCHED_COOP itself does not need it, but preemptive
    baselines weight quanta by it, and the job-level ``SlotArbiter``
    derives the default lease ``share`` from it.

    ``share``/``lease`` are the two-level scheduling fields: ``share`` is
    an optional explicit slot-share weight (``None`` -> derived from
    ``nice``); ``lease`` is set by the arbiter while the job is attached
    (``repro_torch.core.arbiter.SlotLease``) and ``None`` otherwise.
    """

    __slots__ = ("jid", "name", "nice", "quantum", "tasks", "service_time",
                 "share", "lease")

    def __init__(self, name: str, *, nice: int = 0,
                 quantum: Optional[float] = None,
                 share: Optional[float] = None):
        self.jid: int = next(_JID)
        self.name = name
        self.nice = nice
        self.quantum = quantum  # None -> policy default (paper: 20 ms)
        self.share = share      # None -> nice-derived weight (arbiter)
        self.lease: Optional[Any] = None  # SlotLease while attached
        self.tasks: list["Task"] = []
        self.service_time: float = 0.0  # total slot time consumed

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Job({self.name}#{self.jid})"


class Task:
    """A schedulable unit bound to one job.

    ``body`` is executor-specific:
      * events.SimExecutor: a generator factory yielding op tuples
        (see ``repro_torch.core.simtask``);
      * threads.ThreadExecutor: a plain callable run on a real thread.

    A task keeps a *preferred affinity* = the last slot it ran on (§4.1), and
    an optional *user affinity hint* (§4.3.2 — stored, reported back on
    query, but treated as a hint only).

    ``__slots__`` covers the executor-private fields too (sim generator
    state, thread-runtime handles): tasks are the densest hot-path objects
    in the system, and slot access keeps pick/dispatch allocation-free.
    """

    __slots__ = (
        "tid", "job", "body", "name", "cost_hint", "deadline", "state", "slot",
        "last_slot", "user_affinity", "stats", "on_done", "_pending_wakeups",
        "_ctx",
        # sim-executor fields (events.py)
        "_gen", "_send", "_epoch", "_pending", "_pending_started",
        "_warmup_scale", "_owned_mutexes",
        # scheduler bookkeeping (scheduler.py / policies)
        "_blocked_at", "_ready_at", "_yielded", "_slot_state",
        # thread-runtime fields (threads.py)
        "_resume_sem", "_done_event", "_storage", "_exc",
    )

    def __init__(
        self,
        job: Job,
        body: Any = None,
        *,
        name: str = "",
        cost_hint: float = 0.0,
        deadline: Optional[float] = None,
    ):
        self.tid: int = next(_TID)
        self.job = job
        self.body = body
        self.name = name or f"task{self.tid}"
        self.cost_hint = cost_hint
        #: optional absolute completion deadline (scheduler clock domain).
        #: ``None`` (the default) means no SLO: the deadline-aware arbiter
        #: ignores the task and plain arbiters never read the field.
        self.deadline = deadline
        self.state = TaskState.CREATED
        self.slot: Optional[int] = None          # slot currently running on
        self.last_slot: Optional[int] = None     # preferred affinity (§4.1)
        self.user_affinity: Optional[frozenset[int]] = None  # hint (§4.3.2)
        self.stats = TaskStats()
        self.on_done: list[Callable[["Task"], None]] = []
        #: futex-style wakeup counter — an unblock that raced ahead of the
        #: corresponding block (real-thread mode) is remembered, not lost.
        self._pending_wakeups: int = 0
        # executor-private fields:
        self._ctx: Any = None
        self._yielded = False
        self._owned_mutexes: Any = None
        self._warmup_scale: float = 1.0
        #: while RUNNING: the _SlotState of the task's slot, cached so the
        #: real-thread checkpoint fast path is one attribute hop instead of
        #: a slot-table index (scheduler.py sets/clears it at dispatch/stop)
        self._slot_state: Any = None
        job.tasks.append(self)

    # -- affinity hints (paper §4.3.2: setaffinity is a hint; getaffinity
    #    returns the stored hint, not the real placement) ------------------
    def set_affinity_hint(self, slots: frozenset[int]) -> None:
        self.user_affinity = frozenset(slots)

    def get_affinity(self) -> Optional[frozenset[int]]:
        return self.user_affinity

    @property
    def done(self) -> bool:
        return self.state is TaskState.DONE

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Task({self.name}#{self.tid} {self.state.value} j={self.job.name})"
