"""Real-thread USF runtime — the "glibcv" analogue.

Gates genuine Python threads (which dispatch genuine JAX work) through the
central Scheduler:

* ``create()`` is pthread_create (§4.3.1): the new thread is recruited as a
  worker, its task is submitted to the scheduler, and it *parks* until
  dispatched to a slot — freshly created threads never run freely.
* ``join()`` is masked (§4.3.1): the completed worker parks in the thread
  cache; subsequent ``create()`` calls reuse the most recent cached worker
  (Dice & Kogan), avoiding create/destroy cost (the 4x win of Table 2's
  pth rows).
* Blocking primitives in ``repro_torch.core.sync`` call ``pause()`` /
  ``ready()`` — the nosv_pause / nosv_submit analogues.
* A single **watchdog** thread (``UsfRuntime.watchdog``) is the tick
  driver: it times preemption ticks for slots running preemptive-policy
  tasks (never SCHED_COOP — I2 per job) and owns the timer heap behind
  ``sleep()``/timeouts. Ticks become ``request_preempt`` flags that the
  running task consumes at its next scheduling point or explicit
  ``checkpoint()`` — user-space preemption the LibPreemptible way: the
  timer path delivers promptly, the task yields at a safe point.
* ``gating=False`` turns the runtime into the *Linux baseline*: threads run
  free (oversubscribed), synchronization falls back to plain threading —
  the OS scheduler multiplexes.

TLS: a task runs its whole life on one worker thread (tasks migrate between
*slots*, never between threads), so ``threading.local`` written inside a
task is stable across block/resume — the paper's seamlessness claim,
verified in tests/test_threads.py. Worker reuse gives a *new* task a fresh
``task_local()`` dict (pthread_create semantics).
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from repro_torch.core.adaptive import SliceController
from repro_torch.core.arbiter import SlotArbiter
from repro_torch.core.policies.base import Policy
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.task import Job, Task, TaskState
from repro_torch.core.topology import Topology


class UsfError(RuntimeError):
    pass


class UsfTaskError(UsfError):
    """A task body raised: re-surfaced at join (the worker itself parks
    back in the cache — §4.3.1 — so the failure must travel via the task)."""

    def __init__(self, task: Task, tb: str):
        super().__init__(f"task {task.name!r} of {task.job.name!r} raised:\n{tb}")
        self.task = task
        self.traceback = tb


_WD_CALL = 0  # payload = _TimerHandle (timed wakeup / timeout callback)
_WD_TICK = 1  # payload = tick interval (one coalesced entry per interval
#               class; the member slots are looked up at pop time)
_WD_KICK = 2  # payload = slot_id (urgent flag service: fires immediately
#               instead of waiting out the slot's class deadline)


class _TimerHandle:
    """Cancellable one-shot timer entry (threading.Timer analogue, but it
    lives in the watchdog's heap instead of owning an OS thread)."""

    __slots__ = ("fn", "_wd")

    def __init__(self, fn: Callable[[], None], wd: Optional["_Watchdog"]):
        self.fn: Optional[Callable[[], None]] = fn
        self._wd = wd

    def cancel(self) -> None:
        if self.fn is None:
            return
        self.fn = None  # the heap entry fires as a no-op and is dropped
        if self._wd is not None:
            self._wd._note_cancel()  # lazy compaction keeps the heap O(live)


class _Watchdog:
    """The real-thread tick driver: ONE timer thread owning a deadline heap.

    Two entry kinds share the heap:

    * **preemption ticks**, coalesced by *interval class*: every slot
      running a preemptive-policy task joins the class of its policy's
      tick period, and all slots of a class ride ONE periodic heap entry
      — the heap holds O(distinct intervals) tick entries, not O(slots),
      so hundreds of slots at a couple of slice lengths cost two entries
      per period instead of hundreds. A slot is armed only while it runs
      a task whose *own* intra-job policy is preemptive (SCHED_COOP slots
      are never ticked, keeping I2 per job); a policy swap moves the slot
      between classes (an earlier class deadline still supersedes a
      longer pending one). On expiry the scheduler is asked ``tick(slot)``
      for each member slot; a True answer (slice expiry, or the
      lease-revocation condition for an over-lease borrower) becomes
      ``request_preempt``, which the running task consumes at its next
      scheduling point or explicit ``usf.checkpoint()``. This is what
      makes preemptive policies and mid-run ``lease.resize()`` reclaim
      land under real threads.
    * **timed wakeups** (``call_at``/``call_later``): ``sleep()``, timed
      ``join()`` and timed waits route here instead of spawning one
      ``threading.Timer`` thread per call.

    The thread starts lazily on the first armed entry, so a runtime that
    never sleeps and never attaches a preemptive policy pays nothing.
    """

    def __init__(self, runtime: "UsfRuntime"):
        self._rt = runtime
        self._cv = threading.Condition(threading.Lock())
        self._heap: list[tuple] = []  # (deadline, seq, kind, payload)
        self._seq = 0
        # -- interval-class coalescing state (all under self._cv) -------- #
        #: interval -> member slots riding that class's periodic entry
        self._classes: dict[float, set[int]] = {}
        #: interval -> deadline of the class's single pending heap entry;
        #: absent = no entry pending (pushed again when a slot joins or
        #: the class re-arms after a fire)
        self._class_deadline: dict[float, float] = {}
        #: slot -> the interval class it currently rides (at most one:
        #: re-arming with a different period migrates the slot)
        self._slot_interval: dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._cancelled = 0  # dead call entries since the last compaction
        #: adaptive tick-period controller: the class *key* stays the base
        #: interval (the heap stays O(interval classes)); only the re-arm
        #: deadline uses the effective period (repro_torch.core.adaptive)
        self.slices = SliceController()
        #: ticks fired / preemptions requested (introspection + benchmarks)
        self.ticks_fired = 0
        self.preempts_requested = 0
        #: urgent condition-variable kicks serviced
        self.kicks = 0

    # -- arming (any thread) ------------------------------------------- #
    def call_at(self, deadline: float, fn: Callable[[], None]) -> _TimerHandle:
        handle = _TimerHandle(fn, self)
        with self._cv:
            if not self._stop:
                self._push(deadline, _WD_CALL, handle)
                return handle
        # stopped runtime: fire degenerately now rather than dropping the
        # wakeup — a sleeper that would otherwise park forever wakes early
        fn()
        return handle

    def _note_cancel(self) -> None:
        """Compact the heap once cancelled entries dominate: a cancelled
        long timeout (e.g. a 300 s request deadline that resolved in ms)
        must not pin its waiter closure until the original deadline."""
        with self._cv:
            self._cancelled += 1
            if self._cancelled <= 32 or 2 * self._cancelled <= len(self._heap):
                return
            live = [e for e in self._heap
                    if e[2] != _WD_CALL or e[3].fn is not None]
            heapq.heapify(live)
            self._heap[:] = live  # in place: _main binds the list object
            self._cancelled = 0
            self._cv.notify()  # head may have changed: re-time the wait

    def call_later(self, delay: float, fn: Callable[[], None]) -> _TimerHandle:
        return self.call_at(time.monotonic() + delay, fn)

    def arm_tick(self, slot_id: int, interval: float) -> None:
        """Join the slot to the tick class of ``interval``.

        Slots sharing a tick period ride one periodic heap entry, so
        re-arming an already-member slot is a dict lookup, not a heap
        push. A slot armed with a *different* period (a policy handoff)
        migrates between classes only when the new class would service it
        EARLIER — an arm never lengthens a pending service, so a racing
        stale re-arm (e.g. the fire loop's, whose interval was computed
        just before a live swap armed the shorter class) cannot clobber
        the earlier tick. A slot left in a shorter class by a swap to a
        longer period settles into the right class at that shorter
        class's next fire (the fire-loop re-arm sees no current class
        then)."""
        with self._cv:
            if self._stop:
                return
            cur = self._slot_interval.get(slot_id)
            if cur == interval:
                return  # already riding this class's periodic entry
            effective = self.slices.effective
            if cur is not None:
                now = time.monotonic()
                cur_dl = self._class_deadline.get(cur, now + effective(cur))
                new_dl = self._class_deadline.get(interval,
                                                  now + effective(interval))
                if cur_dl <= new_dl:
                    return  # pending service is already no later: keep it
                self._classes[cur].discard(slot_id)
            self._slot_interval[slot_id] = interval
            members = self._classes.get(interval)
            if members is None:
                members = self._classes[interval] = set()
            members.add(slot_id)
            if interval not in self._class_deadline:
                # the adaptive controller sets the class's *effective*
                # period; the class identity (heap key) stays the base
                # interval, so coalescing is untouched
                deadline = time.monotonic() + effective(interval)
                self._class_deadline[interval] = deadline
                self._push(deadline, _WD_TICK, interval)

    def kick(self, slot_id: int) -> None:
        """Urgent flag service: wake the driver NOW for one slot instead
        of letting the flag wait out the slot's class deadline (the
        condition-variable kick of the fast preempt cycle). The scheduler's
        ``on_urgent`` hook lands here — under the scheduler lock, which is
        safe: the established lock order is scheduler -> watchdog CV and
        the driver never takes the scheduler lock while holding the CV."""
        with self._cv:
            if self._stop:
                return
            self.kicks += 1
            self._push(0.0, _WD_KICK, slot_id)

    def tick_heap_stats(self) -> dict:
        """Introspection (tests/benchmarks): the coalescing contract is
        ``tick_entries <= interval_classes`` — never O(slots_armed)."""
        with self._cv:
            return {
                "tick_entries": sum(1 for e in self._heap
                                    if e[2] == _WD_TICK),
                "interval_classes": len(self._class_deadline),
                "slots_armed": len(self._slot_interval),
                "timed_wakeups": sum(1 for e in self._heap
                                     if e[2] == _WD_CALL
                                     and e[3].fn is not None),
                "heap_len": len(self._heap),
            }

    def _push(self, deadline: float, kind: int, payload) -> None:
        # caller holds self._cv
        if self._stop:
            return
        seq = self._seq
        self._seq = seq + 1
        entry = (deadline, seq, kind, payload)
        heapq.heappush(self._heap, entry)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._main, name="usf-watchdog", daemon=True
            )
            self._thread.start()
        elif self._heap[0] is entry:
            self._cv.notify()  # new earliest deadline: re-time the wait

    # -- the driver loop ------------------------------------------------ #
    def _main(self) -> None:
        heap = self._heap
        while True:
            with self._cv:
                while not self._stop:
                    if not heap:
                        self._cv.wait()
                        continue
                    delay = heap[0][0] - time.monotonic()
                    if delay <= 0.0:
                        break
                    self._cv.wait(delay)
                if self._stop:
                    return
                entry = heapq.heappop(heap)
                if entry[2] == _WD_TICK:
                    interval = entry[3]
                    if self._class_deadline.get(interval) != entry[0]:
                        continue  # stale token (class was torn down)
                    del self._class_deadline[interval]
                    # detach the whole class under the lock: member slots
                    # re-join via arm_tick (from _fire's re-arm loop or a
                    # concurrent dispatch) which re-pushes ONE fresh entry
                    slots = self._classes.pop(interval, set())
                    for sid in slots:
                        if self._slot_interval.get(sid) == interval:
                            del self._slot_interval[sid]
                    entry = (entry[0], entry[1], _WD_TICK,
                             (interval, slots))
            try:
                self._fire(entry)  # outside the watchdog lock
            except Exception:  # one bad callback must not kill the driver:
                # every later sleep()/timeout/preemption rides this thread
                import sys
                import traceback

                print("usf-watchdog: timer callback raised:\n"
                      + traceback.format_exc(), file=sys.stderr)

    def _fire(self, entry: tuple) -> None:
        kind = entry[2]
        if kind == _WD_CALL:
            fn = entry[3].fn
            if fn is not None:
                fn()
            return
        sched = self._rt.sched
        if kind == _WD_KICK:
            # urgent single-slot service: same verdict/flag/re-arm path as
            # a periodic tick, just now instead of at the class deadline
            slot_id = entry[3]
            self.ticks_fired += 1
            try:
                flagged, interval, depth, laxity = \
                    sched.tick_and_rearm(slot_id)
            except Exception:
                import sys
                import traceback

                print(f"usf-watchdog: kick for slot {slot_id} raised:\n"
                      + traceback.format_exc(), file=sys.stderr)
                return
            if flagged:
                self.preempts_requested += 1
            if interval:
                self.slices.observe(interval, depth=depth, laxity=laxity)
                self.arm_tick(slot_id, interval)
            return
        interval_cls, slots = entry[3]
        observed = False
        for slot_id in slots:
            self.ticks_fired += 1
            try:
                # verdict + flag + re-arm decision under ONE scheduler lock
                flagged, interval, depth, laxity = \
                    sched.tick_and_rearm(slot_id)
            except Exception:
                # a raising custom should_preempt must only cost ITS slot
                # one tick, not disarm every sibling slot of the class —
                # the whole class was detached at pop time. Re-arm the
                # failing slot at its old class period so a transient
                # error does not silence its ticks until the next dispatch
                import sys
                import traceback

                print(f"usf-watchdog: tick for slot {slot_id} raised:\n"
                      + traceback.format_exc(), file=sys.stderr)
                self.arm_tick(slot_id, interval_cls)
                continue
            if not observed:
                # one adaptation observation per class fire (before the
                # member re-arms, so the new effective period applies to
                # the class entry they push)
                self.slices.observe(interval_cls, depth=depth, laxity=laxity)
                observed = True
            if flagged:
                self.preempts_requested += 1
            # re-join a class while the slot still runs a preemptive-policy
            # task (the flagged task keeps its slot until it reaches a
            # preemption point); after a policy swap this may be a
            # *different* class than the one that just fired. Idle slots
            # simply drop out — the next dispatch re-arms them.
            if interval:
                self.arm_tick(slot_id, interval)

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            # keep the pending timed wakeups: ticks may be dropped, but a
            # sleeper/timeout waiter must never be left parked forever
            pending = [e for e in self._heap if e[2] == _WD_CALL]
            self._heap.clear()
            self._classes.clear()
            self._class_deadline.clear()
            self._slot_interval.clear()
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        for entry in pending:  # fire early (after the thread quit: no dupes)
            fn = entry[3].fn
            if fn is not None:
                fn()


class _Worker:
    """A cached OS thread that serves one task at a time."""

    __slots__ = ("thread", "inbox", "name", "_sem")

    def __init__(self, runtime: "UsfRuntime", idx: int):
        self.name = f"usf-worker-{idx}"
        self.inbox: "deque[Optional[Task]]" = deque()
        self._sem = threading.Semaphore(0)
        self.thread = threading.Thread(
            target=runtime._worker_main, args=(self,), name=self.name, daemon=True
        )
        self.thread.start()

    def assign(self, task: Optional[Task]) -> None:
        self.inbox.append(task)
        self._sem.release()

    def take(self) -> Optional[Task]:
        self._sem.acquire()
        return self.inbox.popleft()


class UsfRuntime:
    """One per node — the shared nOS-V instance analogue (multi-job)."""

    def __init__(
        self,
        topology: Topology,
        policy: Policy,
        *,
        gating: bool = True,
        thread_cache: bool = True,
        arbiter: Optional[SlotArbiter] = None,
    ):
        self.topology = topology
        self.gating = gating
        self.thread_cache_enabled = thread_cache
        self._tls = threading.local()
        self._cache: deque[_Worker] = deque()
        self._all_workers: list[_Worker] = []
        self._cache_lock = threading.Lock()
        self._widx = 0
        self._shutdown = False
        self.cache_hits = 0
        self.cache_misses = 0
        #: the tick driver (single watchdog thread, started lazily)
        self.watchdog = _Watchdog(self)
        #: True once any attached (or default) intra-job policy is
        #: preemptive: gates the per-dispatch policy lookup so purely
        #: cooperative runtimes pay nothing for the tick driver
        self._ticks_enabled = bool(policy.preemptive and policy.tick_interval)
        self.sched = Scheduler(
            topology,
            policy,
            clock=time.monotonic,
            dispatch=self._on_dispatch,
            arbiter=arbiter,
        )
        #: urgent flags (deadline arbiter) kick the watchdog CV instead of
        #: waiting out the pending class deadline
        self.sched.on_urgent = self.watchdog.kick

    # ------------------------------------------------------------------ #
    # pthread-like API
    # ------------------------------------------------------------------ #
    def create(
        self,
        fn: Callable[..., Any],
        args: tuple = (),
        kwargs: Optional[dict] = None,
        *,
        job: Job,
        name: str = "",
        deadline: Optional[float] = None,
    ) -> Task:
        """pthread_create: recruit a (new or cached) worker for a new task.

        ``deadline`` (absolute, scheduler clock domain) rides on the task:
        a deadline-aware arbiter folds it into its grant order the moment
        the task turns READY — including an urgent grant when the deadline
        is already past."""
        if self._shutdown:
            raise UsfError("runtime is shut down")
        task = Task(job, body=(fn, args, kwargs or {}), name=name,
                    deadline=deadline)
        task._resume_sem = threading.Semaphore(0)  # type: ignore[attr-defined]
        task._done_event = threading.Event()  # type: ignore[attr-defined]
        task._storage = {}  # type: ignore[attr-defined]  # fresh task-locals
        task.on_done.append(lambda t: t._done_event.set())  # type: ignore[attr-defined]
        worker = self._get_worker()
        task._ctx = worker
        worker.assign(task)
        return task

    def join(self, task: Task, timeout: Optional[float] = None) -> bool:
        """pthread_join, masked (§4.3.1): the worker is already parked in the
        cache; we only wait for task completion. A gated caller blocks
        cooperatively (releases its slot); an external thread just waits.

        Returns False on timeout. If the task body raised, the exception is
        re-surfaced here as ``UsfTaskError`` instead of silently reporting
        completion."""
        cur = self.current_task()
        ev: threading.Event = task._done_event  # type: ignore[attr-defined]
        if cur is None or not self.gating:
            if not ev.wait(timeout):
                return False
            self._check_task_exc(task)
            return True
        # registration must be atomic wrt finish() (which runs on_done under
        # the scheduler lock), or the wakeup could be lost. The wake fires
        # at most once, from either completion or the timeout timer.
        woken = [False]

        def wake_once(_t=None) -> None:
            with self.sched._lock:
                if woken[0]:
                    return
                woken[0] = True
                self.sched.unblock(cur)

        with self.sched._lock:
            if task.done:
                self._check_task_exc(task)
                return True
            task.on_done.append(wake_once)
        timer: Optional[_TimerHandle] = None
        if timeout is not None:
            timer = self.watchdog.call_later(timeout, wake_once)
        self.sched.block(cur)
        self._park(cur)
        if timer is not None:
            timer.cancel()
        if task.done:
            self._check_task_exc(task)
            return True
        return False

    def _check_task_exc(self, task: Task) -> None:
        exc = getattr(task, "_exc", None)
        if exc is not None:
            raise UsfTaskError(task, exc)

    # ------------------------------------------------------------------ #
    # job-level attach/detach (nosv_attach analogue, two-level scheduling)
    # ------------------------------------------------------------------ #
    def attach(self, job: Job, *, policy: Optional[Policy] = None,
               share: Optional[float] = None):
        """Register ``job`` with an optional dedicated intra-job policy and
        slot share; returns its ``SlotLease``.

        A job already attached is re-homed LIVE — promoted out of the
        default group, or policy-swapped in place when already dedicated:
        queued tasks migrate to the new policy, running tasks keep their
        slots and route later scheduling points there. Preemptive policies
        get watchdog ticks: slice expiry and lease reclaim land within one
        tick period at the task's next scheduling point or checkpoint
        (SCHED_COOP jobs are never ticked — reclaim from them waits for
        their next blocking point, I2)."""
        lease = self.sched.attach_job(job, policy=policy, share=share)
        self._arm_running(job)
        return lease

    def demote(self, job: Job, *, share: Optional[float] = None):
        """Live dedicated→default re-homing (the reverse attach edge):
        the job's dedicated lease/policy group is released and its work —
        queued and running — moves into the shared default group without
        quiescence; returns the new default-group lease."""
        lease = self.sched.demote_job(job, share=share)
        self._arm_running(job)
        return lease

    def _arm_running(self, job: Job) -> None:
        """Arm ticks for a re-homed job's RUNNING tasks when its (new)
        policy is preemptive: they were dispatched before the policy
        change, so dispatch-time arming never saw them."""
        pol = self.sched.policy_of(job)
        if pol.preemptive and pol.tick_interval:
            self._ticks_enabled = True
            for slot_id in self.sched.slots_running(job):
                self.watchdog.arm_tick(slot_id, pol.tick_interval)

    def detach(self, job: Job) -> None:
        """Unregister a quiescent job, releasing its lease to the siblings."""
        self.sched.detach_job(job)

    def set_slot_target(self, n: Optional[int]) -> int:
        """Elastic slot parking: cap the runtime's effective width at ``n``
        slots (``None`` restores the full topology); returns the target.

        Surplus slots park at their tasks' next scheduling point (the
        need-resched / lease-revocation path — within one watchdog tick
        period for preemptive-policy tasks with checkpoints); a regrow
        unparks and refills immediately. Floored at one slot, so a broker
        revoke can throttle this process but never deadlock it. This is
        the landing point of node-level grants (``repro_torch.ipc.BrokerClient``
        binds it) and works equally for in-process width caps."""
        return self.sched.set_slot_target(n)

    def runnable_backlog(self) -> int:
        """Instantaneous READY + RUNNING count (``Scheduler.runnable_backlog``,
        a lock-free probe): the live demand a bound ``BrokerClient``
        piggybacks on its heartbeats so the node broker can tell an idle
        process from a saturated one."""
        return self.sched.runnable_backlog()

    def set_recorder(self, rec) -> None:
        """Arm (or, with ``None``, disarm) a trace decision recorder on the
        live runtime: ``rec((t, code, a, b))`` is invoked under the scheduler
        lock at every decision point (``repro_torch.trace.TraceRecorder.emit`` is
        the usual target — see ``TraceRecorder.attach_runtime``). Disarmed,
        every decision path pays a single predicate check."""
        self.sched._rec = rec

    # ------------------------------------------------------------------ #
    # nOS-V-like blocking API (used by repro_torch.core.sync)
    # ------------------------------------------------------------------ #
    def current_task(self) -> Optional[Task]:
        return getattr(self._tls, "task", None)

    def pause(self) -> None:
        """nosv_pause: the calling task blocks; its slot swaps in another.

        The caller must have made itself discoverable (e.g. queued itself on
        a sync object) *before* calling pause — wakeups that race ahead are
        absorbed by the scheduler's pending-wakeup counter.
        """
        task = self._require_task()
        self.sched.block(task)
        self._park(task)

    def ready(self, task: Task) -> None:
        """nosv_submit: mark a paused task ready (queued, not resumed — I3)."""
        self.sched.unblock(task)

    def yield_now(self) -> None:
        """sched_yield → nosv_yield: requeue behind peers, maybe resume."""
        task = self._require_task()
        self.sched.yield_(task)
        self._park(task)

    def sleep(self, seconds: float) -> None:
        """nosv_waitfor: timed block; auto-resubmitted when the watchdog's
        timer heap fires (one shared thread, not a Timer thread per call)."""
        task = self._require_task()
        self.watchdog.call_later(seconds, lambda: self.sched.unblock(task))
        self.sched.block(task)
        self._park(task)

    def call_later(self, delay: float, fn: Callable[[], None]) -> _TimerHandle:
        """Timed callback on the watchdog's shared timer heap (the
        ``threading.Timer`` replacement used by the sync primitives)."""
        return self.watchdog.call_later(delay, fn)

    def checkpoint(self) -> None:
        """Explicit preemption point (LibPreemptible-style): a compute loop
        that never blocks calls this periodically.

        Fast path: two lock-free attribute reads against the slot state
        the scheduler cached on the task at dispatch — the need-resched
        flag, then the precomputed absolute slice expiry. A checkpoint
        that crosses the expiry *self-ticks* through
        ``Scheduler.poll_preempt`` (verdict re-validated under the lock):
        the preempt cycle completes at checkpoint latency instead of
        waiting out a watchdog tick, which is what takes the end-to-end
        ``sched.preempt_cycle`` number from tick-period-bound (~100/s) to
        checkpoint-bound. The watchdog remains the backstop for tasks
        that checkpoint rarely (and the only driver for lease-revocation
        flags on slots whose task never self-expires).

        Safe to call from anywhere: a plain (non-USF) thread and a
        free-running (``gating=False``) task both no-op, so library code
        can sprinkle checkpoints unconditionally — the auto-checkpoint
        wrappers (``repro_torch.core.autockpt``) rely on this to keep
        instrumented code identical between coordinated runs and
        free-running baselines. The full delivery-latency ladder
        (blocking point / explicit checkpoint / auto-checkpoint at
        dispatch / watchdog backstop) is documented in
        docs/PREEMPTION.md."""
        task = self.current_task()
        if task is None:
            return  # plain thread: checkpoints are unconditional no-ops
        st = task._slot_state
        if st is None:
            return  # not scheduler-dispatched (free-running baseline mode)
        if st.need_resched:
            if self.sched.consume_preempt(task):
                self._park(task)
            return
        expiry = st.slice_expiry
        if expiry and time.monotonic() >= expiry \
                and self.sched.poll_preempt(task):
            self._park(task)

    def task_local(self) -> dict:
        """Per-task storage (fresh per task even on worker reuse)."""
        return self._require_task()._storage  # type: ignore[attr-defined]

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def shutdown(self, timeout: float = 10.0) -> None:
        """Unpark, detach and truly join all cached workers (§4.3.1)."""
        self._shutdown = True
        self.watchdog.stop()
        with self._cache_lock:
            workers = list(self._all_workers)
            self._cache.clear()
        for w in workers:
            w.assign(None)  # poison pill
        deadline = time.monotonic() + timeout
        for w in workers:
            w.thread.join(max(0.0, deadline - time.monotonic()))

    def stats(self) -> dict:
        s = self.sched.stats().as_dict()
        s["cache_hits"] = self.cache_hits
        s["cache_misses"] = self.cache_misses
        s["workers"] = len(self._all_workers)
        s["watchdog_ticks"] = self.watchdog.ticks_fired
        s["watchdog_preempt_requests"] = self.watchdog.preempts_requested
        s["watchdog_kicks"] = self.watchdog.kicks
        s["poll_preempts"] = self.sched.poll_preempts
        return s

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _require_task(self) -> Task:
        t = self.current_task()
        if t is None:
            raise UsfError("not inside a USF task")
        return t

    def _get_worker(self) -> _Worker:
        with self._cache_lock:
            if self.thread_cache_enabled and self._cache:
                self.cache_hits += 1
                return self._cache.pop()  # most recent first (warm)
            self.cache_misses += 1
            w = _Worker(self, self._widx)
            self._widx += 1
            self._all_workers.append(w)
            return w

    def _park(self, task: Task) -> None:
        """Wait until the scheduler dispatches ``task`` to a slot again."""
        task._resume_sem.acquire()  # type: ignore[attr-defined]

    def _on_dispatch(self, task: Task, slot_id: int) -> None:
        if self._ticks_enabled:
            pol = self.sched.policy_of(task.job)
            if pol.preemptive and pol.tick_interval:
                # stamp the absolute slice expiry BEFORE waking the worker:
                # checkpoints self-detect expiry lock-free against this
                # (the fast preempt cycle); the watchdog tick stays armed
                # as the backstop for checkpoint-free stretches
                sl = pol.slice_for(task)
                st = self.sched._slots[slot_id]
                st.slice_expiry = (st.run_started + sl) if sl else 0.0
                self.watchdog.arm_tick(slot_id, pol.tick_interval)
        task._resume_sem.release()  # type: ignore[attr-defined]

    def _worker_main(self, worker: _Worker) -> None:
        while True:
            task = worker.take()
            if task is None:
                return  # detached at shutdown
            self._tls.task = task
            try:
                fn, args, kwargs = task.body
                if self.gating:
                    # nosv_attach: submit + park until first dispatch
                    self.sched.submit(task)
                    self._park(task)
                    try:
                        fn(*args, **kwargs)
                    except BaseException:
                        import traceback

                        # record BEFORE finish(): join waiters wake inside
                        # finish() and must observe the failure (no race)
                        task._exc = traceback.format_exc()  # type: ignore[attr-defined]
                    finally:
                        self.sched.finish(task)
                else:
                    # free-running Linux-baseline mode
                    self.sched.register_job(task.job)
                    task.state = TaskState.RUNNING
                    now = time.monotonic()
                    task.stats.created_at = task.stats.created_at or now
                    task.stats.first_run_at = now
                    try:
                        fn(*args, **kwargs)
                    except BaseException:
                        import traceback

                        task._exc = traceback.format_exc()  # type: ignore[attr-defined]
                    finally:
                        task.state = TaskState.DONE
                        task.stats.done_at = time.monotonic()
                        for cb in task.on_done:
                            cb(task)
            except Exception:  # pragma: no cover - runtime-internal failure
                import traceback

                task._exc = traceback.format_exc()  # type: ignore[attr-defined]
                if not getattr(task, "_done_event", None) or not task._done_event.is_set():  # type: ignore[attr-defined]
                    task._done_event.set()  # type: ignore[attr-defined]
            finally:
                self._tls.task = None
                if not self._shutdown:
                    with self._cache_lock:
                        if self.thread_cache_enabled:
                            self._cache.append(worker)
                        else:
                            self._all_workers.remove(worker)
                    if not self.thread_cache_enabled:
                        return  # thread truly exits (pth-style create/destroy)
