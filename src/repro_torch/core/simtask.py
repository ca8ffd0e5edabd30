"""Simulation task vocabulary: ops and synchronization objects.

A sim task body is a generator yielding *op tuples*; the discrete-event
engine (events.py) interprets them. Ops mirror the glibc APIs the paper
interposes (§4.3.4: mutex, condvar, barrier, semaphore, sleep, yield, poll)
plus compute, spawn/join (pthread_create/join, §4.3.1) and a channel
(poll/epoll-style request queues for the microservices benchmark).

Values can be received from ops:  ``item = yield channel_get(ch)``.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Optional

from repro_torch.core.task import Task

_OID = itertools.count()


# --------------------------------------------------------------------------- #
# op constructors (plain tuples; constructors only prevent typos)
# --------------------------------------------------------------------------- #
def compute(seconds: float, *, flops: float = 0.0) -> tuple:
    """Uninterrupted useful work for ``seconds`` (preemptible by preemptive
    policies). ``flops`` is bookkeeping for throughput metrics."""
    return ("compute", float(seconds), float(flops))


def stall(seconds: float) -> tuple:
    """Work that holds the slot but is *not* useful (un-intercepted blocking
    I/O, §5.6: 'blocking MPI communications stall cores until they complete')."""
    return ("stall", float(seconds))


def lock(m: "SimMutex") -> tuple:
    return ("lock", m)


def unlock(m: "SimMutex") -> tuple:
    return ("unlock", m)


def barrier_wait(b: "SimBarrier") -> tuple:
    return ("barrier", b)


def spin_barrier_wait(b: "SimSpinBarrier") -> tuple:
    return ("spin_barrier", b)


def sem_acquire(s: "SimSemaphore") -> tuple:
    return ("sem_acquire", s)


def sem_release(s: "SimSemaphore") -> tuple:
    return ("sem_release", s)


def cv_wait(cv: "SimCondVar", m: "SimMutex") -> tuple:
    return ("cv_wait", cv, m)


def cv_notify(cv: "SimCondVar", n: int = 1) -> tuple:
    return ("cv_notify", cv, n)


def sleep(seconds: float) -> tuple:
    """nosv_waitfor-style timed block: slot is released, task auto-resubmits."""
    return ("sleep", float(seconds))


def sleep_until(t: float) -> tuple:
    """Absolute-time block: wake at virtual time ``t`` (clamped to now).
    The trace replayer encodes recorded sync blocks with this, replaying
    each wake at its recorded timestamp."""
    return ("sleep_until", float(t))


def yield_() -> tuple:
    return ("yield",)


def checkpoint() -> tuple:
    """Explicit preemption point (usf.checkpoint analogue): consumes a
    pending external preemption request against the task's slot, else a
    no-op that keeps the generator advancing synchronously."""
    return ("checkpoint",)


def spawn(task: Task) -> tuple:
    return ("spawn", task)


def join(task: Task) -> tuple:
    return ("join", task)


def channel_put(ch: "SimChannel", item: Any) -> tuple:
    return ("channel_put", ch, item)


def channel_get(ch: "SimChannel") -> tuple:
    return ("channel_get", ch)


# --------------------------------------------------------------------------- #
# synchronization objects (state only; engine interprets)
# --------------------------------------------------------------------------- #
class _SyncObj:
    def __init__(self) -> None:
        self.oid = next(_OID)


class SimMutex(_SyncObj):
    """Paper Listing 1: FIFO wait queue; unlock transfers ownership."""

    def __init__(self) -> None:
        super().__init__()
        self.owner: Optional[Task] = None
        self.queue: Deque[Task] = deque()


class SimBarrier(_SyncObj):
    """Cooperative (blocking) barrier: arrivals block, last arrival releases."""

    def __init__(self, parties: int):
        super().__init__()
        assert parties >= 1
        self.parties = parties
        self.count = 0
        self.generation = 0
        self.waiting: Deque[Task] = deque()


class SimSpinBarrier(_SyncObj):
    """Busy-wait barrier (the §5.2/§4.4 troublemaker).

    Spinning *consumes the slot*. ``yield_every`` is the paper's one-line
    adaptation (occasional sched_yield); ``None`` reproduces the unmodified
    OpenBLAS/BLIS/MPICH behaviour, which can livelock SCHED_COOP when
    waiting threads exceed slots (§4.4) and wastes quanta under preemptive
    scheduling (§5.3 'Original').
    """

    def __init__(self, parties: int, *, spin_slice: float = 50e-6,
                 yield_every: Optional[int] = 0):
        super().__init__()
        assert parties >= 1
        self.parties = parties
        self.spin_slice = spin_slice
        # yield_every=0 means "yield every check" (sched_yield loop);
        # None means never yield (pure busy wait).
        self.yield_every = yield_every
        self.count = 0
        self.generation = 0


class SimSemaphore(_SyncObj):
    def __init__(self, value: int = 0):
        super().__init__()
        self.value = value
        self.queue: Deque[Task] = deque()


class SimCondVar(_SyncObj):
    def __init__(self) -> None:
        super().__init__()
        self.waiting: Deque[tuple[Task, "SimMutex"]] = deque()


class SimChannel(_SyncObj):
    """FIFO message queue; ``get`` blocks when empty (epoll-ish wait)."""

    def __init__(self) -> None:
        super().__init__()
        self.items: Deque[Any] = deque()
        self.getters: Deque[Task] = deque()


@dataclasses.dataclass
class SimCosts:
    """Calibration constants for the event engine.

    Defaults are CPU-node ballparks (context switch ~5 us, NUMA-local warm-up
    ~20 us, remote ~100 us). ``cache_refill`` is charged when a task resumes
    on a slot whose cache another task polluted in between (the preemption
    cache-pollution effect the paper targets); per-task ``warmup_scale``
    scales all warm-up penalties by working-set size (ws_bytes / mem_bw).
    TPU-slot runs override these with HBM state-swap costs.
    """

    ctx_switch: float = 5e-6
    migration_domain: float = 20e-6
    migration_cross: float = 100e-6
    cache_refill: float = 20e-6
    dispatch_latency: float = 1e-6

    def migration_penalty(self, distance: int) -> float:
        if distance <= 0:
            return 0.0
        return self.migration_domain if distance == 1 else self.migration_cross
