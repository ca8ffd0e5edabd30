"""The centralized USF scheduler.

Invariants (paper §2.3/§4.1, property-tested in tests/test_scheduler_props.py):

  I1. At most one RUNNING task per slot at any time ("exactly one running
      worker pinned per core").
  I2. Task swaps happen only at *scheduling points*: block, yield, end — or
      an explicit preemption tick when a preemptive baseline policy is
      active (the Linux stand-in). SCHED_COOP never preempts.
  I3. Unblocked tasks are NOT resumed immediately; they are queued and the
      policy decides placement later (§4.1 "these threads are not resumed
      immediately. Instead, they are queued within the scheduler").
  I4. A task that ends its body is parked, not destroyed, when a worker
      cache is attached (§4.3.1) — executor-level behaviour.

  I5. Two-level lease rule (arbiter.py): no job is *granted* a slot beyond
      its current lease while a sibling policy group has ready tasks and
      spare lease (work-conserving borrowing otherwise).

The scheduler is executor-agnostic: the discrete-event engine (events.py)
and the real-thread runtime (threads.py) both drive it through the same
six entry points: ``submit / block / unblock / yield_ / finish / tick``.

Two-level architecture: the scheduler owns slots, scheduling points and
invariants; *which job* gets a freed slot and *which task* of that job runs
is delegated to a job-level ``SlotArbiter`` routing to per-job intra-job
policies (one job can run SCHED_COOP while a co-located job runs
SCHED_FAIR). With a single policy group the arbiter is a transparent
pass-through to the default policy.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.core.arbiter import SlotArbiter, SlotLease
from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.stats import SchedStats, collect
from repro_torch.core.task import Job, Task, TaskState
from repro_torch.core.topology import Topology


class SchedulerError(RuntimeError):
    pass


# --------------------------------------------------------------------- #
# trace decision-record codes (repro_torch.trace builds on these; they live
# here so core never imports the trace package). An armed recorder is
# called as ``rec((t, code, a, b))`` — ONE pre-built record tuple, so the
# recorder can be a bare C-level ``deque.append`` with no Python frame.
# --------------------------------------------------------------------- #
(REC_OP, REC_SPAWN, REC_DISPATCH, REC_BLOCK, REC_YIELD, REC_DONE,
 REC_PREEMPT, REC_WAKE, REC_JOB, REC_ATTACH, REC_DEMOTE, REC_DETACH,
 REC_TARGET, REC_RESIZE, REC_DL_POST, REC_DL_RETIRE, REC_URGENT,
 REC_REQUEST, REC_REQ_DONE) = range(19)

#: StopReason -> decision code for the one shared stop site
_REC_STOP = {
    StopReason.BLOCK: REC_BLOCK,
    StopReason.YIELD: REC_YIELD,
    StopReason.DONE: REC_DONE,
    StopReason.PREEMPT: REC_PREEMPT,
}


def _pol_desc(policy: Optional[Policy]):
    """Serializable (name, param) description of an intra-job policy —
    enough for the replayer to rebuild an equivalent instance."""
    if policy is None:
        return None
    for attr in ("slice_s", "quantum", "default_quantum"):
        v = getattr(policy, attr, None)
        if v is not None:
            return (policy.name, v)
    return (policy.name, None)


class _SlotState:
    __slots__ = ("running", "run_started", "idle_since", "need_resched",
                 "slice_expiry", "successor")

    def __init__(self) -> None:
        self.running: Optional[Task] = None
        self.run_started: float = 0.0
        self.idle_since: float = 0.0
        #: set by request_preempt (watchdog tick / lease revocation); the
        #: running task's next scheduling point or explicit checkpoint
        #: consumes it and converts into a preempt/yield
        self.need_resched: bool = False
        #: absolute clock time at which the running task's slice expires
        #: (0.0 = no self-expiry). The real-thread checkpoint fast path
        #: compares against this WITHOUT taking the scheduler lock, so a
        #: slice expiry is noticed at the very next checkpoint instead of
        #: waiting out a watchdog tick period — the core of the fast
        #: preempt cycle. A stale read is benign: ``poll_preempt``
        #: re-validates the verdict under the lock.
        self.slice_expiry: float = 0.0
        #: preferred successor for the next fill of this slot (urgent-grant
        #: redispatch hint, set by a deadline-aware arbiter): consumed —
        #: and validated — by ``_fill`` before falling back to a full pick.
        self.successor: Optional[Task] = None


class Scheduler:
    """Central multi-job scheduler (the shared nOS-V instance analogue).

    Parameters
    ----------
    topology:  the slot/domain layout.
    policy:    the *default* intra-job policy (SCHED_COOP at most call
               sites): jobs that never attach with a dedicated policy are
               multiplexed by this one, exactly as before the two-level
               split. Per-job policies are added via ``attach_job``.
    clock:     zero-arg callable returning the current time. Virtual in the
               event engine, ``time.monotonic`` in the thread runtime.
    dispatch:  executor callback ``(task, slot_id) -> None`` that actually
               resumes the task on the slot.
    ctx_switch_cost: accounted (and, in the sim, *charged*) per swap.
    arbiter:   optional job-level arbiter instance (default: a fresh
               ``SlotArbiter``). Pass a ``DeadlineArbiter`` for EDF /
               least-laxity grant ordering (repro_torch.core.deadline).
    """

    def __init__(
        self,
        topology: Topology,
        policy: Policy,
        *,
        clock: Callable[[], float],
        dispatch: Callable[[Task, int], None],
        ctx_switch_cost: float = 0.0,
        arbiter: Optional[SlotArbiter] = None,
    ):
        self.topology = topology
        #: the default intra-job policy (kept by name for back-compat; the
        #: authoritative router is ``self.arbiter``)
        self.policy = policy
        self.clock = clock
        self._dispatch_cb = dispatch
        self.ctx_switch_cost = ctx_switch_cost
        self._slots = [_SlotState() for _ in topology.slots]
        #: idle-slot free-list: exactly the slots with ``running is None``
        #: that are not parked. Maintained by _run_on/_stop_running so fill
        #: never scans all slots.
        self._idle: set[int] = set(range(topology.n_slots))
        #: elastic slot parking (node-level coordination): slots withdrawn
        #: from dispatch because the effective width was capped below the
        #: topology (``set_slot_target`` — a broker revoke, or an explicit
        #: cap). A slot is in exactly one of {running, _idle, _parked}.
        self._parked: set[int] = set()
        #: the effective width; == n_slots means parking is inert (the
        #: single compare in ``_fill`` is the whole fast-path cost)
        self._slot_target: int = topology.n_slots
        self.jobs: dict[int, Job] = {}
        self.all_tasks: list[Task] = []
        self._lock = threading.RLock()
        self._ctx_switch_time = 0.0
        self._started_at = self.clock()
        #: preemptions initiated by the checkpoint self-tick fast path
        #: (``poll_preempt``) rather than a watchdog request
        self.poll_preempts = 0
        #: executor hook fired (under the scheduler lock) when an urgent
        #: preemption request lands on a slot — the real-thread runtime
        #: binds this to the watchdog's condition-variable kick so the
        #: request is serviced immediately instead of at the next tick.
        self.on_urgent: Optional[Callable[[int], None]] = None
        #: decision-record hook (repro_torch.trace): ``None`` when disarmed — the
        #: hot paths pay exactly one predicate check; armed, it is called
        #: as ``rec((t, code, a, b))`` under the scheduler lock, so records
        #: are totally ordered exactly like the decisions themselves.
        self._rec = None
        #: job-level slot arbiter: every scheduling point routes through it
        self.arbiter = arbiter if arbiter is not None else SlotArbiter(policy)
        self.arbiter.attach(self)

    # ------------------------------------------------------------------ #
    # job / task registration (nOS-V process registration analogue)
    # ------------------------------------------------------------------ #
    def register_job(self, job: Job) -> Job:
        with self._lock:
            self.jobs[job.jid] = job
            self.arbiter.on_job(job)
            rec = self._rec
            if rec is not None:
                rec((self.clock(), REC_JOB, job.jid,
                     (job.name, job.nice, job.share)))
        return job

    def attach_job(self, job: Job, *, policy: Optional[Policy] = None,
                   share: Optional[float] = None) -> SlotLease:
        """nosv_attach analogue: register ``job`` with an optional dedicated
        intra-job policy and an explicit slot share; returns its lease."""
        with self._lock:
            lease = self.arbiter.attach_job(job, policy=policy, share=share)
            self.jobs[job.jid] = job
            rec = self._rec
            if rec is not None:
                rec((self.clock(), REC_ATTACH, job.jid,
                     (share, _pol_desc(policy))))
            self._fill_idle_slots(self.clock())
            return lease

    def demote_job(self, job: Job, *, share: Optional[float] = None
                   ) -> SlotLease:
        """Live dedicated→default re-homing: release the job's dedicated
        lease/policy group and move its work — READY tasks re-queued
        exactly once, RUNNING tasks keeping their slots — into the shared
        default group. No quiescence required (the any↔any migration
        matrix; ``detach_job`` remains the teardown path)."""
        with self._lock:
            lease = self.arbiter.demote_job(job, share=share)
            rec = self._rec
            if rec is not None:
                rec((self.clock(), REC_DEMOTE, job.jid, share))
            self._fill_idle_slots(self.clock())
            return lease

    def detach_job(self, job: Job) -> None:
        """nosv_detach analogue: unregister a quiescent job, freeing its
        lease for the siblings (raises if it still has READY/RUNNING work).
        A later submit — or a blocked task waking up — re-registers it."""
        with self._lock:
            self.arbiter.detach_job(job)
            self.jobs.pop(job.jid, None)
            rec = self._rec
            if rec is not None:
                rec((self.clock(), REC_DETACH, job.jid, None))
            self._fill_idle_slots(self.clock())

    def policy_of(self, job: Job) -> Policy:
        """The intra-job policy currently serving ``job``'s tasks."""
        return self.arbiter.policy_of(job)

    # ------------------------------------------------------------------ #
    # elastic slot parking (node-level width coordination)
    # ------------------------------------------------------------------ #
    def set_slot_target(self, n: Optional[int]) -> int:
        """Cap the effective width at ``n`` slots (``None`` restores the
        full topology); returns the effective target.

        This is how a node-level grant/revoke (``repro_torch.ipc``) — or any
        in-process width cap — lands on a live scheduler:

        * **shrink**: surplus *idle* slots park immediately; surplus
          *running* slots are flagged need-resched (the same flag the
          lease-revocation path uses), so each parks at its task's next
          scheduling point or explicit ``checkpoint()`` — for preemptive
          intra-job policies that is within one tick period. The running
          task is requeued, not lost: it resumes on a surviving slot.
        * **grow**: parked slots rejoin the idle pool and are refilled
          with queued work immediately (work-conserving grant).

        The target is floored at one slot: a process is never throttled to
        zero width (liveness — a dead or miserly broker must degrade a
        worker, never deadlock it). Job leases re-apportion over the
        *active* pool so intra-process shares keep tracking quotas.
        """
        with self._lock:
            n_total = len(self._slots)
            target = n_total if n is None else max(1, min(int(n), n_total))
            self._slot_target = target
            now = self.clock()
            active = n_total - len(self._parked)
            if active < target:
                for sid in sorted(self._parked):
                    if active >= target:
                        break
                    self._parked.discard(sid)
                    self._idle.add(sid)
                    self._slots[sid].idle_since = now
                    active += 1
            elif active > target:
                surplus = active - target
                # park idle slots first (highest ids — deterministic)...
                for sid in sorted(self._idle, reverse=True):
                    if surplus == 0:
                        break
                    self._idle.discard(sid)
                    self._parked.add(sid)
                    surplus -= 1
                # ...then flag surplus running slots: their tasks park the
                # slot at their next scheduling point (need-resched, the
                # lease-revocation path)
                if surplus:
                    for sid in range(n_total - 1, -1, -1):
                        if surplus == 0:
                            break
                        st = self._slots[sid]
                        if st.running is not None and not st.need_resched:
                            st.need_resched = True
                            surplus -= 1
            rec = self._rec
            if rec is not None:
                rec((now, REC_TARGET, target, None))
            self.arbiter.set_capacity(target)
            self._fill_idle_slots(now)
            return target

    def slot_target(self) -> int:
        return self._slot_target

    def runnable_backlog(self) -> int:
        """Instantaneous runnable backlog: READY + RUNNING task count.

        Lock-free by design — this is the demand probe a ``BrokerClient``
        heartbeat samples from its beat thread (``repro_torch.ipc``), so it must
        never contend with the dispatch hot path. The reads race benignly:
        ``ready_count`` sums per-policy counters and the running count is
        derived from set sizes; a transiently stale sample is smoothed out
        by the broker's demand damping anyway."""
        running = len(self._slots) - len(self._idle) - len(self._parked)
        return max(0, self.arbiter.ready_count() + running)

    def parked_slot_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._parked)

    # ------------------------------------------------------------------ #
    # the six scheduling entry points
    # ------------------------------------------------------------------ #
    def submit(self, task: Task) -> None:
        """New or re-submitted task becomes READY and is queued (never runs
        directly — glibcv blocks freshly created pthreads until dispatched)."""
        with self._lock:
            now = self.clock()
            if task.job.jid not in self.jobs:
                self.register_job(task.job)
            if task.state is TaskState.CREATED:
                self.all_tasks.append(task)
                task.stats.created_at = now
                rec = self._rec
                if rec is not None:
                    rec((now, REC_SPAWN, task.tid,
                         (task.job.jid, task.deadline, task.cost_hint)))
            self._make_ready(task, now)
            self._fill_idle_slots(now)

    def unblock_batch(self, tasks) -> None:
        """Unblock several tasks under one lock acquisition, preserving the
        per-task make-ready/fill sequence (same placement as N unblocks).
        The event engine uses this to coalesce same-timestamp wakeups."""
        with self._lock:
            now = self.clock()
            rec = self._rec
            for task in tasks:
                if task.state is not TaskState.BLOCKED:
                    task._pending_wakeups += 1
                    continue
                task.stats.blocked_time += now - task._blocked_at  # type: ignore[attr-defined]
                if rec is not None:
                    rec((now, REC_WAKE, task.tid, None))
                self._make_ready(task, now)
                self._fill_idle_slots(now)

    def block(self, task: Task) -> Optional[Task]:
        """Task reached a blocking point: free its slot, swap in the next.

        Returns the replacement task (for the executor), if any. If an
        ``unblock`` raced ahead of this block (real threads), the task is
        requeued immediately instead of parking (futex wake-before-wait).
        """
        with self._lock:
            slot, now = self._stop_running(task, StopReason.BLOCK)
            if task._pending_wakeups > 0:
                task._pending_wakeups -= 1
                self._make_ready(task, now)
            else:
                task.state = TaskState.BLOCKED
                task._blocked_at = now  # type: ignore[attr-defined]
            return self._fill(slot, now)

    def unblock(self, task: Task) -> None:
        """Blocking condition satisfied: queue the task (I3), fill idle slots."""
        with self._lock:
            if task.state is not TaskState.BLOCKED:
                # raced ahead of the block (real-thread mode): remember it
                task._pending_wakeups += 1
                return
            now = self.clock()
            task.stats.blocked_time += now - task._blocked_at  # type: ignore[attr-defined]
            rec = self._rec
            if rec is not None:
                rec((now, REC_WAKE, task.tid, None))
            self._make_ready(task, now)
            self._fill_idle_slots(now)

    def yield_(self, task: Task) -> Optional[Task]:
        """Voluntary yield (sched_yield / nosv_yield): requeue behind peers.

        Returns the task to run next on the slot (possibly the same task when
        nothing else is ready — yield is then a no-op, as on Linux).
        """
        with self._lock:
            slot, now = self._stop_running(task, StopReason.YIELD)
            task.stats.yields += 1
            task._yielded = True  # policies deprioritize: go to the back
            self._make_ready(task, now)
            return self._fill(slot, now)

    def finish(self, task: Task) -> Optional[Task]:
        """Task body ended: mark DONE, run callbacks, swap in the next."""
        with self._lock:
            slot, now = self._stop_running(task, StopReason.DONE)
            task.state = TaskState.DONE
            task.stats.done_at = now
            for cb in task.on_done:
                cb(task)
            return self._fill(slot, now)

    def preempt(self, task: Task) -> Optional[Task]:
        """Involuntary preemption — only preemptive intra-job policies (I2
        is per job now: a SCHED_COOP job is never preempted even while a
        co-located SCHED_FAIR job is)."""
        with self._lock:
            pol = self.arbiter.policy_of(task.job)
            if not pol.preemptive:
                raise SchedulerError(f"{pol.name} must not preempt (I2)")
            slot, now = self._stop_running(task, StopReason.PREEMPT)
            task.stats.preemptions += 1
            self._make_ready(task, now)
            return self._fill(slot, now)

    def tick(self, slot_id: int) -> bool:
        """Periodic tick (preemptive policies): should the slot's task be
        preempted now? The *executor* then calls ``preempt``. Routed to the
        running task's own policy; the arbiter also turns this into the
        lease-revocation scheduling point for over-lease preemptive jobs.
        A pending asynchronous preemption request (``request_preempt`` /
        ``urgent_preempt``) is honoured here too — a tick is a scheduling
        point, and ticks only ever fire on preemptive-policy slots."""
        with self._lock:
            st = self._slots[slot_id]
            if st.running is None:
                return False
            return st.need_resched or \
                self.arbiter.should_preempt(st.running, slot_id, self.clock())

    # ------------------------------------------------------------------ #
    # deferred preemption (real-thread tick driver)
    # ------------------------------------------------------------------ #
    def tick_request(self, slot_id: int) -> bool:
        """``tick`` + ``request_preempt`` under ONE lock acquisition, so
        the need-resched flag can only land on the task the verdict was
        about — with two separate calls the slot could swap in between
        and a SCHED_COOP task could get flagged. Kept for external tick
        drivers; the watchdog itself uses ``tick_and_rearm`` (same
        verdict logic, not a duplicate — this delegates)."""
        return self.tick_and_rearm(slot_id)[0]

    def tick_and_rearm(self, slot_id: int
                       ) -> tuple[bool, Optional[float], int, Optional[float]]:
        """``tick_request`` plus the watchdog's re-arm decision under ONE
        lock acquisition: returns (flagged, tick_interval, ready_depth,
        laxity) where ``tick_interval`` is the running task's policy
        period when that policy is preemptive (else None),
        ``ready_depth`` is the arbiter-wide ready-queue depth and
        ``laxity`` the arbiter's deadline headroom (None without a
        deadline-aware arbiter) — the two signals the adaptive slice
        controller shrinks/grows tick classes from. The coalesced fire
        loop calls this once per member slot instead of several lock
        round-trips, and the re-arm verdict is guaranteed to be about the
        same task the tick verdict was."""
        with self._lock:
            st = self._slots[slot_id]
            task = st.running
            if task is None:
                return False, None, 0, None
            now = self.clock()
            flagged = False
            if self.arbiter.should_preempt(task, slot_id, now):
                st.need_resched = True
                flagged = True
            pol = self.arbiter.policy_of(task.job)
            return (flagged,
                    (pol.tick_interval if pol.preemptive else None),
                    self.arbiter.ready_count(),
                    self.arbiter.laxity_headroom(now))

    def request_preempt(self, slot_id: int) -> bool:
        """Mark the slot need-resched (asynchronous preemption request).

        Real threads cannot be descheduled from outside: the watchdog tick
        driver calls this instead, and the running task's *next* scheduling
        point — or an explicit ``usf.checkpoint()`` preemption point —
        consumes the flag and converts into a preempt (I2: only ever
        requested for preemptive-policy tasks). Returns False if the slot
        was already idle (nothing to preempt)."""
        with self._lock:
            st = self._slots[slot_id]
            if st.running is None:
                return False
            st.need_resched = True
            return True

    def preempt_requested(self, task: Task) -> bool:
        """Lock-free peek for the checkpoint fast path: a stale read is
        benign (``consume_preempt`` re-checks under the lock)."""
        slot = task.slot
        return slot is not None and self._slots[slot].need_resched

    def consume_preempt(self, task: Task) -> bool:
        """Explicit preemption point: honour a pending ``request_preempt``.

        Returns True if the task was descheduled (the executor must park it
        until redispatch); the pending request converts into a ``preempt``
        for preemptive intra-job policies and a plain ``yield_`` otherwise
        (only reachable through a user-placed checkpoint in a cooperative
        task — the watchdog never flags SCHED_COOP slots)."""
        with self._lock:
            slot = task.slot
            if slot is None or not self._slots[slot].need_resched:
                return False
            if self.arbiter.policy_of(task.job).preemptive:
                self.preempt(task)
            else:
                self.yield_(task)
            return True

    def poll_preempt(self, task: Task) -> bool:
        """Checkpoint-driven slice-expiry poll — the self-ticking half of
        the fast preempt cycle.

        The real-thread runtime stamps ``_SlotState.slice_expiry`` at
        dispatch (run_started + the policy's per-task slice); a checkpoint
        that observes the expiry lock-free lands here, where the verdict is
        re-validated under the lock: exactly what a watchdog tick arriving
        at this instant would decide, but at checkpoint latency instead of
        tick latency. Returns True if the task was descheduled (the
        executor must park it). On a False verdict the expiry is pushed one
        slice forward so an uncontended loop does not take the lock at
        every checkpoint."""
        with self._lock:
            slot = task.slot
            if slot is None:
                return False
            st = self._slots[slot]
            if st.running is not task:
                return False
            if st.need_resched or \
                    self.arbiter.should_preempt(task, slot, self.clock()):
                self.poll_preempts += 1
                if self.arbiter.policy_of(task.job).preemptive:
                    self.preempt(task)
                else:
                    self.yield_(task)
                return True
            sl = self.arbiter.policy_of(task.job).slice_for(task)
            st.slice_expiry = (self.clock() + sl) if sl else 0.0
            return False

    def urgent_preempt(self, slot_id: int,
                       successor: Optional[Task] = None) -> bool:
        """``request_preempt`` plus the urgent extras under ONE lock: stash
        the preferred ``successor`` on the slot (consumed by the next
        ``_fill`` — redispatch skips the full pick) and fire the executor's
        ``on_urgent`` hook (the real-thread runtime kicks the watchdog's
        condition variable so the flag is serviced immediately instead of
        at the next heap deadline). Used by the deadline arbiter when a
        job's laxity goes negative. Returns False if the slot was idle."""
        with self._lock:
            st = self._slots[slot_id]
            if st.running is None:
                return False
            st.need_resched = True
            if successor is not None:
                st.successor = successor
            rec = self._rec
            if rec is not None:
                rec((self.clock(), REC_URGENT, slot_id,
                     None if successor is None else successor.tid))
            if self.on_urgent is not None:
                self.on_urgent(slot_id)
            return True

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _make_ready(self, task: Task, now: float) -> None:
        task.state = TaskState.READY
        task._ready_at = now  # type: ignore[attr-defined]
        self.arbiter.on_ready(task)

    def _stop_running(self, task: Task, reason: StopReason) -> tuple[int, float]:
        if task.state is not TaskState.RUNNING or task.slot is None:
            raise SchedulerError(f"stop of non-running {task}")
        slot = task.slot
        st = self._slots[slot]
        if st.running is not task:  # I1 violated
            raise SchedulerError(f"slot {slot} does not run {task}")
        now = self.clock()
        elapsed = now - st.run_started
        task.stats.run_time += elapsed
        task.job.service_time += elapsed
        rec = self._rec
        if rec is not None:
            rec((now, _REC_STOP[reason], task.tid, slot))
        self.arbiter.on_stop(task, slot, now, elapsed, reason)
        st.running = None
        st.need_resched = False  # any scheduling point satisfies the request
        st.slice_expiry = 0.0
        st.idle_since = now
        self._idle.add(slot)
        task._slot_state = None
        task.slot = None
        task.last_slot = slot  # preferred affinity for next time (§4.1)
        return slot, now

    def _fill(self, slot_id: int, now: float) -> Optional[Task]:
        """Pick and dispatch the next task for an idle slot."""
        st = self._slots[slot_id]
        if st.running is not None:
            return None
        if self._slot_target < len(self._slots) and \
                len(self._slots) - len(self._parked) > self._slot_target:
            # elastic parking: the effective width is capped and this slot
            # is surplus — withdraw it instead of refilling (the slot's
            # previous task, if any, was requeued by its scheduling point
            # and will resume on a surviving slot)
            self._idle.discard(slot_id)
            self._parked.add(slot_id)
            return None
        hint = st.successor
        if hint is not None:
            # urgent-grant redispatch: the arbiter already chose the
            # successor when it flagged this slot — claim it from its
            # policy queue and skip the full pick. The hint is validated
            # (still READY, still claimable); anything stale falls through
            # to the normal pick.
            st.successor = None
            if hint.state is TaskState.READY and self.arbiter.claim(hint):
                return self._run_on(hint, slot_id, now)
        task = self.arbiter.pick(slot_id)
        if task is None:
            return None
        return self._run_on(task, slot_id, now)

    def _fill_idle_slots(self, now: float) -> None:
        idle = self._idle
        arbiter = self.arbiter
        if not idle or not arbiter.has_ready():
            return
        for sid in sorted(idle):
            if self._slots[sid].running is None:
                if self._fill(sid, now) is None and not arbiter.has_ready():
                    break  # nothing ready for anyone

    def _run_on(self, task: Task, slot_id: int, now: float) -> Task:
        st = self._slots[slot_id]
        assert st.running is None, "I1"
        task.stats.wait_time += now - task._ready_at  # type: ignore[attr-defined]
        if task.stats.first_run_at is None:
            task.stats.first_run_at = now
        if task.last_slot is not None and task.last_slot != slot_id:
            task.stats.migrations += 1
            if self.topology.distance(task.last_slot, slot_id) >= 2:
                task.stats.cross_domain_migrations += 1
        task.state = TaskState.RUNNING
        task.slot = slot_id
        task.stats.dispatches += 1
        st.running = task
        st.run_started = now
        task._slot_state = st  # checkpoint fast path: one attribute hop
        self._idle.discard(slot_id)
        self._ctx_switch_time += self.ctx_switch_cost
        rec = self._rec
        if rec is not None:
            rec((now, REC_DISPATCH, task.tid, slot_id))
        self.arbiter.on_run(task, slot_id, now)
        self._dispatch_cb(task, slot_id)
        return task

    # ------------------------------------------------------------------ #
    # introspection / diagnostics
    # ------------------------------------------------------------------ #
    def running_on(self, slot_id: int) -> Optional[Task]:
        """Lock-free peek at one slot (single-threaded executors only —
        the sim engine's tick path; racy under the real-thread runtime)."""
        return self._slots[slot_id].running

    def running_tasks(self) -> list[Optional[Task]]:
        with self._lock:
            return [s.running for s in self._slots]

    def slots_running(self, job: Job) -> list[int]:
        """Slots currently running ``job``'s tasks (executors use this to
        arm preemption ticks for a live re-homed job)."""
        with self._lock:
            return [i for i, s in enumerate(self._slots)
                    if s.running is not None and s.running.job is job]

    def idle_slot_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._idle)

    def snapshot(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for t in self.all_tasks:
                states[t.state.value] = states.get(t.state.value, 0) + 1
            return {
                "now": self.clock(),
                "policy": self.arbiter.describe(),
                "slots_busy": (self.topology.n_slots - len(self._idle)
                               - len(self._parked)),
                "slots": self.topology.n_slots,
                "slots_parked": len(self._parked),
                "slot_target": self._slot_target,
                "task_states": states,
                "ready": self.arbiter.ready_count(),
                "leases": self.arbiter.lease_snapshot(),
            }

    def stats(self) -> SchedStats:
        with self._lock:  # all_tasks/slot accounting mutate under _lock
            s = collect(
                self.all_tasks,
                makespan=self.clock() - self._started_at,
                n_slots=self.topology.n_slots,
            )
            s.context_switch_time = self._ctx_switch_time
        return s
