"""Discrete-event executor for USF.

Runs sim tasks (generators of ops, see simtask.py) on a virtual-time machine
under any Policy, through the *same* Scheduler as the real-thread runtime.
This is how we run the paper's experiments at node and pod scale on a 1-core
container, deterministically.

Fidelity notes:

* Preemptive policies get per-slot ticks; preemption mid-compute splits the
  segment and pays a context switch — this is where LHP/LWP emerge naturally
  (a preempted mutex owner keeps its FIFO wait queue stalled).
* Spin barriers consume slot time in ``spin_slice`` quanta; with
  ``yield_every=None`` and a cooperative policy they livelock when waiters
  exceed slots (paper §4.4) — the engine detects this and raises
  ``SimLivelock`` instead of spinning forever.
* Migration penalties (affinity warm-up) are charged on dispatch based on
  topology distance.

Engine fast path: the hot event kinds (dispatch-resume, compute
completion, spin polls, stalls, preemption ticks, sleep wakeups) are
plain ``(time, seq, kind, a, b, c)`` heap tuples dispatched by an
integer tag in a locals-bound drain loop — no per-event closure is
allocated for them. Generic callables (rare: delayed spawns, external
hooks) still go through ``_post``. Consecutive same-timestamp sleep
wakeups are drained as one batch through ``Scheduler.unblock_batch``
(identical per-task semantics, one lock round-trip). ``seq`` is unique,
so tuple comparison never reaches the payload fields.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Optional

from repro_torch.core.adaptive import SliceController
from repro_torch.core.arbiter import SlotArbiter
from repro_torch.core.policies.base import Policy
from repro_torch.core.scheduler import REC_OP, Scheduler
from repro_torch.core.simtask import (
    SimBarrier,
    SimChannel,
    SimCondVar,
    SimCosts,
    SimMutex,
    SimSemaphore,
    SimSpinBarrier,
)
from repro_torch.core.stats import SchedStats
from repro_torch.core.task import Job, Task, TaskState
from repro_torch.core.topology import Topology


def _owned(task: Task) -> set:
    s = task._owned_mutexes
    if s is None:
        s = task._owned_mutexes = set()
    return s


class SimLivelock(RuntimeError):
    pass


class SimTimeout(RuntimeError):
    pass


class SimDeadlock(RuntimeError):
    pass


# heap-event kind tags (values are cosmetic; dispatch is by identity)
_EV_CALL = 0     # a = zero-arg callable (generic / cold path)
_EV_RESUME = 1   # a = task, b = slot_id, c = epoch  (post-dispatch resume)
_EV_COMPUTE = 2  # a = task, b = slot_id, c = epoch  (compute segment done)
_EV_SPIN = 3     # a = task, b = slot_id, c = epoch  (next busy-wait poll)
_EV_STALL = 4    # a = task, b = slot_id, c = epoch  (non-sched-point stall)
_EV_TICK = 5     # a = slot_id                        (preemption tick)
_EV_WAKE = 6     # a = task                           (sleep expiry)
_EV_SUBMIT = 7   # a = task                           (deferred arrival)

#: body ops the recording advance loop captures verbatim (numeric payloads
#: only — sync ops are reconstructed from the BLOCK/WAKE decision records
#: instead, see trace/replayer.py)
_REC_OPKINDS = frozenset(
    ("compute", "stall", "sleep", "sleep_until", "yield", "checkpoint")
)


class SimExecutor:
    def __init__(
        self,
        topology: Topology,
        policy: Policy,
        *,
        costs: Optional[SimCosts] = None,
        max_time: float = 3600.0,
        max_events: int = 50_000_000,
        arbiter: Optional[SlotArbiter] = None,
    ):
        self.topology = topology
        self.costs = costs or SimCosts()
        self._now = 0.0
        #: (time, seq, kind, a, b, c) — see the _EV_* tags above
        self._heap: list[tuple] = []
        self._seq = 0
        self.max_time = max_time
        self.max_events = max_events
        #: events drained so far (benchmarks/sched_ops.py reads this)
        self.events_processed = 0
        self._useful_flops = 0.0
        #: Lock-Holder-Preemption events: a task preempted while owning a
        #: mutex (the §1/§6 pathology SCHED_COOP eliminates by design).
        self.lhp_preemptions = 0
        #: constant part of every dispatch delay, hoisted out of the hot path
        self._base_delay = self.costs.ctx_switch + self.costs.dispatch_latency
        self.sched = Scheduler(
            topology,
            policy,
            clock=lambda: self._now,
            dispatch=self._on_dispatch,
            ctx_switch_cost=self.costs.ctx_switch,
            arbiter=arbiter,
        )
        #: adaptive tick periods — the SAME deterministic controller the
        #: real-thread watchdog uses (repro_torch.core.adaptive), fed from the
        #: same (queue depth, laxity headroom) observations at tick time,
        #: so adaptive-slice policy behaviour is lockstep-testable in
        #: virtual time. Without deadline pressure the controller is
        #: stateless and every tick deadline equals the base period:
        #: non-deadline simulations stay bit-identical.
        self.slices = SliceController()
        #: slot -> deadline of its authoritative pending preemption tick;
        #: an earlier re-arm (e.g. a live swap to a shorter-slice policy)
        #: supersedes a pending later tick, whose token dies at fire time
        #: — mirrors the real-thread watchdog's class-migration semantics
        self._tick_armed: dict[int, float] = {}
        #: urgent grants (negative-laxity deadline preemptions) are
        #: serviced at an immediate tick event — the virtual-time twin of
        #: the real-thread watchdog's condition-variable kick
        self.sched.on_urgent = self._urgent_kick
        #: cache residency: which task's working set last warmed each slot
        self._slot_last: dict[int, int] = {}
        #: intrinsic-op recorder (trace.recorder) — None when disarmed;
        #: arming swaps _advance for its recording twin (see
        #: _set_op_recorder), so plain runs pay nothing, not even a check
        self._oprec = None

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def now(self) -> float:
        return self._now

    def spawn(self, job: Job, genfn: Callable[[], Any], *, name: str = "",
              at: float = 0.0, warmup_scale: float = 1.0,
              deadline: Optional[float] = None) -> Task:
        """Create a task whose body is ``genfn()`` and submit it at time
        ``at``. ``deadline`` (absolute virtual time) rides on the task: a
        deadline-aware arbiter folds it into its grant order the moment
        the task turns READY."""
        task = Task(job, body=genfn, name=name, deadline=deadline)
        task._warmup_scale = warmup_scale  # type: ignore[attr-defined]
        if at <= self._now:
            self._submit(task)
        else:
            self._post_ev(at, _EV_SUBMIT, task)
        return task

    def feed(self, arrivals) -> None:
        """Stream task arrivals into the run: ``arrivals`` yields
        ``(time, task)`` pairs sorted by time. Exactly one arrival event
        is in the heap at any moment — the drain loop pulls the next pair
        when it fires — so replaying a million-task trace does not flood
        the heap (and every pop stays shallow). Tasks must be fresh
        (CREATED) ``Task`` objects; times must be non-decreasing and not
        in the past."""
        it = iter(arrivals)
        for at, task in it:
            self._post_ev(at, _EV_SUBMIT, task, it)
            break

    def attach(self, job: Job, *, policy: Optional[Policy] = None,
               share: Optional[float] = None):
        """nosv_attach: register ``job`` with an optional dedicated
        intra-job policy + slot share; returns its ``SlotLease``. A job
        with queued/running work is re-homed live — promotion out of the
        default group, or a live policy swap when already dedicated (see
        SlotArbiter); tasks already running under a newly preemptive
        policy get their slots' preemption ticks armed here (new
        dispatches arm themselves)."""
        lease = self.sched.attach_job(job, policy=policy, share=share)
        self._arm_running(job)
        return lease

    def demote(self, job: Job, *, share: Optional[float] = None):
        """Reverse nosv_attach edge: live re-home a dedicated ``job`` into
        the shared default group (dedicated lease/policy released, tasks
        keep running); returns the new default-group lease."""
        lease = self.sched.demote_job(job, share=share)
        self._arm_running(job)
        return lease

    def _arm_running(self, job: Job) -> None:
        """Arm preemption ticks for a re-homed job's RUNNING tasks when
        its (new) policy is preemptive — they were dispatched before the
        policy change, so dispatch-time arming never saw them."""
        pol = self.sched.policy_of(job)
        if pol.preemptive and pol.tick_interval is not None:
            for slot_id in self.sched.slots_running(job):
                self._arm_tick(slot_id, self.sched.running_on(slot_id))

    def detach(self, job: Job) -> None:
        """nosv_detach: unregister a quiescent job, releasing its lease."""
        self.sched.detach_job(job)

    def set_slot_target(self, n: Optional[int]) -> int:
        """Elastic slot parking in virtual time: cap the effective width at
        ``n`` slots (``None`` restores the topology). Surplus slots park at
        their tasks' next scheduling point, exactly like the real-thread
        runtime — the deterministic twin for testing node-level revokes."""
        return self.sched.set_slot_target(n)

    def runnable_backlog(self) -> int:
        """Instantaneous READY + RUNNING count (``Scheduler.runnable_backlog``)
        — the live-demand probe a ``BrokerClient`` heartbeat reports."""
        return self.sched.runnable_backlog()

    def run(self, *, until: Optional[float] = None) -> SchedStats:
        """Drain all events (or run until virtual time ``until``)."""
        limit = until if until is not None else self.max_time
        # bind hot attributes to locals: this loop is the whole sim
        heap = self._heap
        heappop = heapq.heappop
        heappush = heapq.heappush
        resume = self._resume
        advance = self._advance
        submit = self._submit
        sched = self.sched
        unblock_batch = sched.unblock_batch
        max_events = self.max_events
        RUNNING = TaskState.RUNNING
        oprec = self._oprec
        n = 0
        uf = 0.0
        try:
            while heap:
                entry = heap[0]
                t = entry[0]
                if t > limit:
                    self._now = limit
                    if until is None:
                        self._raise_stuck()
                    break
                heappop(heap)
                self._now = t
                kind = entry[2]
                if kind == _EV_RESUME:
                    resume(entry[3], entry[4], entry[5])
                elif kind == _EV_COMPUTE:
                    # replay fast path: _valid inlined, pending flops read
                    # from the op tuple itself (no per-event allocation),
                    # and a compute->compute chain handled entirely in this
                    # frame — next(body) feeds the next segment without a
                    # generator-frame round-trip through _advance. Bodies
                    # may be plain iterators (the replayer uses C-level
                    # tuple iterators); anything that is not a bare
                    # compute chain falls back to the generic paths.
                    task = entry[3]
                    slot_id = entry[4]
                    if (task._epoch == entry[5]
                            and task.state is RUNNING
                            and task.slot == slot_id):
                        uf += task._pending[2]
                        if oprec is None and task._send is None:
                            try:
                                op = next(task._gen)
                            except StopIteration:
                                task._pending = None
                                task._epoch = entry[5] + 1
                                sched.finish(task)
                            else:
                                if op[0] == "compute":
                                    task._pending = op
                                    task._pending_started = t
                                    seq = self._seq
                                    self._seq = seq + 1
                                    heappush(heap, (t + op[1], seq,
                                                    _EV_COMPUTE, task,
                                                    slot_id, entry[5]))
                                else:
                                    task._pending = None
                                    if self._handle(task, slot_id, op):
                                        advance(task, slot_id)
                        else:
                            task._pending = None
                            advance(task, slot_id)
                elif kind == _EV_WAKE:
                    # batch same-timestamp sleep expiries: one lock
                    # round-trip, identical per-task make-ready/fill order.
                    # Counting is structural — the extras drained here plus
                    # the shared increment below make events_processed equal
                    # exactly the number of heap pops, so recorder event
                    # counts and the events/s gate agree with the decision
                    # stream even when wakeups coalesce.
                    task = entry[3]
                    if heap and heap[0][0] == t and heap[0][2] == _EV_WAKE:
                        batch = [task]
                        while heap and heap[0][0] == t and heap[0][2] == _EV_WAKE:
                            batch.append(heappop(heap)[3])
                        n += len(batch) - 1
                        unblock_batch(batch)
                    else:
                        sched.unblock(task)
                elif kind == _EV_SUBMIT:
                    # b (entry[4]) may carry an arrival stream: an iterator
                    # of (time, task) pairs, pre-sorted by time. The drain
                    # loop pulls one arrival per submit event, so a
                    # million-task replay keeps the heap shallow (no
                    # pre-posted arrival flood) with no feeder closures.
                    submit(entry[3])
                    stream = entry[4]
                    if stream is not None:
                        for at, nxt in stream:
                            seq = self._seq
                            self._seq = seq + 1
                            heappush(heap, (at, seq, _EV_SUBMIT, nxt,
                                            stream, None))
                            break
                elif kind == _EV_SPIN:
                    task = entry[3]
                    slot_id = entry[4]
                    if self._valid(task, slot_id, entry[5]):
                        pend = task._pending
                        self._spin_check(task, slot_id, pend[1], pend[2],
                                         pend[3])
                elif kind == _EV_STALL:
                    task = entry[3]
                    if self._valid(task, entry[4], entry[5]):
                        advance(task, entry[4])
                elif kind == _EV_TICK:
                    self._tick(entry[3])
                else:  # _EV_CALL
                    entry[3]()
                n += 1
                if n > max_events:
                    raise SimTimeout(
                        f"event cap exceeded: {self.sched.snapshot()}"
                    )
        finally:
            self.events_processed += n
            self._useful_flops += uf
        if until is None and not self._heap:
            undone = [t for t in self.sched.all_tasks if not t.done]
            if undone:
                raise SimDeadlock(
                    f"no pending events but {len(undone)} tasks unfinished "
                    f"(cooperative deadlock): {self.sched.snapshot()}"
                )
        return self.sched.stats()

    @property
    def useful_flops(self) -> float:
        return self._useful_flops

    # ------------------------------------------------------------------ #
    # engine internals
    # ------------------------------------------------------------------ #
    def _post(self, t: float, fn: Callable[[], None]) -> None:
        """Generic (cold-path) event: a zero-arg callable."""
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (t, seq, _EV_CALL, fn, None, None))

    def _post_ev(self, t: float, kind: int, a=None, b=None, c=None) -> None:
        """Closure-free hot-path event."""
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (t, seq, kind, a, b, c))

    def _submit(self, task: Task) -> None:
        task._gen = task.body()  # type: ignore[attr-defined]
        task._send = None  # type: ignore[attr-defined]
        task._epoch = 0  # type: ignore[attr-defined]
        task._pending = None  # type: ignore[attr-defined]  # resumable op state
        self.sched.submit(task)

    def _on_dispatch(self, task: Task, slot_id: int) -> None:
        """Scheduler picked ``task`` for ``slot_id``: resume after swap costs."""
        epoch = task._epoch
        scale = task._warmup_scale
        delay = self._base_delay
        if task.last_slot is not None and task.last_slot != slot_id:
            dist = self.topology.distance(task.last_slot, slot_id)
            delay += self.costs.migration_penalty(dist) * scale
        elif (task.last_slot == slot_id
              and self._slot_last.get(slot_id) not in (None, task.tid)):
            # back on its own slot, but another task polluted the cache in
            # between (preemption/interleaving noise — paper §1, §5.3)
            delay += self.costs.cache_refill * scale
        self._slot_last[slot_id] = task.tid
        self._post_ev(self._now + delay, _EV_RESUME, task, slot_id, epoch)
        self._arm_tick(slot_id, task)

    def _valid(self, task: Task, slot_id: int, epoch: int) -> bool:
        return (
            task._epoch == epoch  # type: ignore[attr-defined]
            and task.state is TaskState.RUNNING
            and task.slot == slot_id
        )

    def _bump(self, task: Task) -> None:
        task._epoch += 1  # type: ignore[attr-defined]

    def _resume(self, task: Task, slot_id: int, epoch: int) -> None:
        if not self._valid(task, slot_id, epoch):
            return
        pending = task._pending  # type: ignore[attr-defined]
        if pending is None:
            self._advance(task, slot_id)
        elif pending[0] == "compute":
            _, remaining, flops = pending
            self._start_compute(task, slot_id, remaining, flops)
        elif pending[0] == "spin":
            _, bar, gen, iters = pending
            self._spin_check(task, slot_id, bar, gen, iters)
        else:  # pragma: no cover - defensive
            raise AssertionError(pending)

    # -- generator advancement ------------------------------------------ #
    def _advance(self, task: Task, slot_id: int) -> None:
        """Pull ops from the task generator until it blocks/computes/ends."""
        gen = task._gen  # type: ignore[attr-defined]
        heappush = heapq.heappush
        heap = self._heap
        while True:
            try:
                send = task._send  # type: ignore[attr-defined]
                if send is None:
                    op = next(gen)  # any iterator works (replay bodies
                    # are C-level tuple iterators — no generator frame)
                else:
                    task._send = None  # type: ignore[attr-defined]
                    op = gen.send(send)
            except StopIteration:
                self._bump(task)
                self.sched.finish(task)
                return
            if op[0] == "compute":
                # hottest op, inlined (it is also first in _handle — this
                # just skips the extra call): keep the body's own
                # ("compute", dt, flops) tuple as the pending state, no
                # per-segment allocation.
                task._pending = op
                now = self._now
                task._pending_started = now
                seq = self._seq
                self._seq = seq + 1
                heappush(heap, (now + op[1], seq, _EV_COMPUTE, task,
                                slot_id, task._epoch))
                return
            if not self._handle(task, slot_id, op):
                return  # task no longer advancing synchronously

    def _set_op_recorder(self, rec) -> None:
        """Arm (or, with ``None``, disarm) intrinsic-op recording. Arming
        shadows ``_advance`` with its recording twin via an instance
        attribute — the disarmed engine keeps the original method and pays
        zero per-op cost. Must be called before ``run`` (the drain loop
        binds ``_advance`` to a local at entry)."""
        self._oprec = rec
        if rec is None:
            self.__dict__.pop("_advance", None)
        else:
            self._advance = self._advance_recording

    def _advance_recording(self, task: Task, slot_id: int) -> None:
        """Recording twin of ``_advance``: emits a REC_OP record for every
        intrinsic (numeric-payload) op the body yields. Sync ops carry live
        object references and are deliberately not recorded — the replayer
        reconstructs each blocking occurrence from the BLOCK/WAKE decision
        records as an absolute-time ``sleep_until``."""
        gen = task._gen  # type: ignore[attr-defined]
        rec = self._oprec
        while True:
            try:
                send = task._send  # type: ignore[attr-defined]
                if send is None:
                    op = next(gen)
                else:
                    task._send = None  # type: ignore[attr-defined]
                    op = gen.send(send)
            except StopIteration:
                self._bump(task)
                self.sched.finish(task)
                return
            if op[0] in _REC_OPKINDS:
                rec((self._now, REC_OP, task.tid, op))
            if not self._handle(task, slot_id, op):
                return

    def _handle(self, task: Task, slot_id: int, op: tuple) -> bool:
        """Returns True if the generator should keep advancing right now."""
        kind = op[0]

        if kind == "compute":
            # hottest op: keep the body's own ("compute", dt, flops) tuple
            # as the pending state (no per-segment allocation) and push the
            # completion event inline. _start_compute remains for the
            # post-preempt resume path, which must rebuild remaining time.
            task._pending = op
            now = self._now
            task._pending_started = now
            seq = self._seq
            self._seq = seq + 1
            heapq.heappush(self._heap, (now + op[1], seq, _EV_COMPUTE, task,
                                        slot_id, task._epoch))
            return False

        if kind == "yield":  # hot under §5.2-adapted workloads: check early
            self._bump(task)
            self.sched.yield_(task)
            return False

        if kind == "checkpoint":
            # explicit preemption point (the sim analogue of
            # usf.checkpoint): a pending request_preempt flag — e.g. from
            # an external preemption request against this slot — is
            # consumed here; unflagged it is a no-op and the generator
            # keeps advancing. The sim is single-threaded, so the flag
            # cannot vanish between the peek and the consume. Bodies need
            # not yield this op by hand: ``autockpt.preemptible_body``
            # injects it every N ops, mirroring the thread executor's
            # checkpoint-at-dispatch wrappers boundary for boundary.
            if self.sched.preempt_requested(task):
                self._bump(task)
                self.sched.consume_preempt(task)
                return False
            return True

        if kind == "stall":
            # holds the slot, not useful, not a scheduling point (§5.6)
            dt = op[1]
            task.stats.spin_time += dt
            self._post_ev(self._now + dt, _EV_STALL, task, slot_id, task._epoch)
            return False

        if kind == "lock":
            m: SimMutex = op[1]
            if m.owner is None:
                m.owner = task
                _owned(task).add(m)
                return True
            m.queue.append(task)  # FIFO wait queue (Listing 1)
            self._block(task)
            # on resume, ownership will have been transferred to us
            _owned(task).add(m)
            return False

        if kind == "unlock":
            m = op[1]
            if m.owner is not task:
                raise RuntimeError(f"{task} unlocks mutex it does not own")
            _owned(task).discard(m)
            if m.queue:
                nxt = m.queue.popleft()
                m.owner = nxt          # ownership transfer (Listing 1)
                self.sched.unblock(nxt)
            else:
                m.owner = None
            return True

        if kind == "barrier":
            b: SimBarrier = op[1]
            b.count += 1
            if b.count == b.parties:
                b.count = 0
                b.generation += 1
                waiters, b.waiting = list(b.waiting), type(b.waiting)()
                for w in waiters:
                    self.sched.unblock(w)
                return True  # last arrival proceeds without blocking
            b.waiting.append(task)
            self._block(task)
            return False

        if kind == "spin_barrier":
            b2: SimSpinBarrier = op[1]
            gen_at_arrival = b2.generation
            b2.count += 1
            if b2.count == b2.parties:
                b2.count = 0
                b2.generation += 1  # releases all spinners at their next check
                return True
            task._pending = ("spin", b2, gen_at_arrival, 0)  # type: ignore[attr-defined]
            self._spin_check(task, slot_id, b2, gen_at_arrival, 0)
            return False

        if kind == "sem_acquire":
            s: SimSemaphore = op[1]
            if s.value > 0:
                s.value -= 1
                return True
            s.queue.append(task)
            self._block(task)
            return False

        if kind == "sem_release":
            s = op[1]
            if s.queue:
                self.sched.unblock(s.queue.popleft())
            else:
                s.value += 1
            return True

        if kind == "cv_wait":
            cv: SimCondVar = op[1]
            m = op[2]
            if m.owner is not task:
                raise RuntimeError("cv_wait without holding the mutex")
            cv.waiting.append((task, m))
            # release the mutex (with FIFO handoff) then block
            if m.queue:
                nxt = m.queue.popleft()
                m.owner = nxt
                self.sched.unblock(nxt)
            else:
                m.owner = None
            self._block(task)
            return False

        if kind == "cv_notify":
            cv = op[1]
            n = op[2]
            for _ in range(min(n, len(cv.waiting))):
                w, wm = cv.waiting.popleft()
                # re-acquire the mutex on the waiter's behalf before resume
                if wm.owner is None:
                    wm.owner = w
                    self.sched.unblock(w)
                else:
                    wm.queue.append(w)  # stays BLOCKED until unlock hands off
            return True

        if kind == "sleep":
            dt = op[1]
            self._block(task)
            self._post_ev(self._now + dt, _EV_WAKE, task)
            return False

        if kind == "sleep_until":
            # absolute-time sleep: the replay encoding of a recorded sync
            # block (trace/replayer.py pairs each BLOCK with its WAKE time).
            # A replayed wake never precedes its block under the recorded
            # policy; the clamp only guards hand-written traces.
            t = op[1]
            now = self._now
            self._block(task)
            self._post_ev(t if t > now else now, _EV_WAKE, task)
            return False

        if kind == "spawn":
            child: Task = op[1]
            if getattr(child, "_gen", None) is None:
                self._submit(child)
            else:
                self.sched.submit(child)
            return True

        if kind == "join":
            child = op[1]
            if child.done:
                return True
            self._block(task)
            child.on_done.append(lambda _t: self.sched.unblock(task))
            return False

        if kind == "channel_put":
            ch: SimChannel = op[1]
            if ch.getters:
                getter = ch.getters.popleft()
                getter._send = op[2]  # type: ignore[attr-defined]
                self.sched.unblock(getter)
            else:
                ch.items.append(op[2])
            return True

        if kind == "channel_get":
            ch = op[1]
            if ch.items:
                task._send = ch.items.popleft()  # type: ignore[attr-defined]
                return True
            ch.getters.append(task)
            self._block(task)
            return False

        raise RuntimeError(f"unknown op {op!r}")

    # -- compute & spin -------------------------------------------------- #
    def _start_compute(self, task: Task, slot_id: int, dt: float, flops: float) -> None:
        task._pending = ("compute", dt, flops)
        task._pending_started = self._now
        self._post_ev(self._now + dt, _EV_COMPUTE, task, slot_id, task._epoch)

    def _spin_check(
        self,
        task: Task,
        slot_id: int,
        bar: SimSpinBarrier,
        my_gen: int,
        iters: int,
    ) -> None:
        """One busy-wait poll iteration (consumes slot time). Only called
        while the task validly runs; ``task._pending`` always holds current
        spin state so preemption/resume can continue the spin."""
        if bar.generation != my_gen:
            task._pending = None  # type: ignore[attr-defined]
            self._advance(task, slot_id)  # released
            return
        task.stats.spin_time += bar.spin_slice
        nxt = iters + 1
        task._pending = ("spin", bar, my_gen, nxt)  # type: ignore[attr-defined]
        ye = bar.yield_every
        if ye is not None and (ye == 0 or nxt % ye == 0):
            # the §5.2 adaptation: occasionally sched_yield inside the spin
            self._bump(task)
            self.sched.yield_(task)
            return
        # next poll; if preempted meanwhile the epoch check kills the event
        # and _pending (always current) lets the resume continue the spin
        self._post_ev(self._now + bar.spin_slice, _EV_SPIN, task, slot_id,
                      task._epoch)

    # -- blocking helper -------------------------------------------------- #
    def _block(self, task: Task) -> None:
        self._bump(task)
        self.sched.block(task)

    # -- preemption ticks -------------------------------------------------- #
    def _arm_tick(self, slot_id: int, task: Optional[Task] = None) -> None:
        """Arm a preemption tick for the task (about to be) running on the
        slot, unless an equal-or-earlier one is pending. Per-job policies
        make this per-task: a SCHED_COOP job's tasks never arm ticks even
        when a co-located job is preemptive. An earlier request (a swap
        to a shorter-slice policy) supersedes a pending later tick."""
        if task is None:
            task = self.sched.running_on(slot_id)
            if task is None:
                return  # armed again on next dispatch
        pol = self.sched.policy_of(task.job)
        if not pol.preemptive or pol.tick_interval is None:
            return
        deadline = self._now + self.slices.effective(pol.tick_interval)
        cur = self._tick_armed.get(slot_id)
        if cur is not None and cur <= deadline:
            return
        self._tick_armed[slot_id] = deadline
        self._post_ev(deadline, _EV_TICK, slot_id)

    def _urgent_kick(self, slot_id: int) -> None:
        """Service an urgent preemption request (``Scheduler.urgent_preempt``)
        at an immediate tick instead of the slot's next periodic deadline:
        the pending later tick becomes a dead token exactly as in a
        shorter-slice re-arm."""
        self._tick_armed[slot_id] = self._now
        self._post_ev(self._now, _EV_TICK, slot_id)

    def _tick(self, slot_id: int) -> None:
        if self._tick_armed.get(slot_id) != self._now:
            return  # superseded by an earlier re-arm: dead token
        del self._tick_armed[slot_id]
        running = self.sched.running_on(slot_id)
        if running is None:
            return  # re-armed on next dispatch
        pol = self.sched.policy_of(running.job)
        if not pol.preemptive:
            # stale tick: armed for a previous preemptive occupant, but the
            # slot now runs a cooperative-policy task (I2: never preempted
            # here even with need_resched set — the flag stays for the task
            # to consume at its next scheduling point / checkpoint)
            return
        if pol.tick_interval is not None:
            # mirror the watchdog's adaptation observation (same controller,
            # same signals) before the re-arm below reads the new period
            arb = self.sched.arbiter
            self.slices.observe(pol.tick_interval,
                                depth=arb.ready_count(),
                                laxity=arb.laxity_headroom(self._now))
        if self.sched.tick(slot_id):
            task = running
            if _owned(task):
                self.lhp_preemptions += 1  # preempted a lock holder (LHP)
            pend = task._pending  # type: ignore[attr-defined]
            if pend is not None and pend[0] == "compute":
                ran = self._now - task._pending_started  # type: ignore[attr-defined]
                left = max(pend[1] - ran, 0.0)
                task._pending = ("compute", left, pend[2])  # type: ignore[attr-defined]
            self._bump(task)
            self.sched.preempt(task)
        self._arm_tick(slot_id)

    # -- failure diagnosis -------------------------------------------------- #
    def _raise_stuck(self) -> None:
        snap = self.sched.snapshot()
        undone = [t for t in self.sched.all_tasks if not t.done]
        if undone:
            spinning = snap["slots_busy"] > 0
            msg = f"simulation exceeded max_time={self.max_time}s: {snap}"
            if spinning:
                raise SimLivelock(
                    msg + " — busy-wait livelock (paper §4.4: adapt the "
                    "barrier with yield_every)"
                )
            raise SimTimeout(msg)
