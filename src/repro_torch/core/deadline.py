"""Deadline-aware job-level arbitration (SLO-native serving).

``DeadlineArbiter`` is the worked example of the ``SlotArbiter`` override
points (``_pick_multi`` / ``_recompute_quotas``): it makes the two-level
scheduler deadline-aware without touching the scheduler core or the
intra-job policies.

Deadline sources, both tracked per *job*:

* **task deadlines** — any READY task whose ``Task.deadline`` is set joins
  its job's deadline heap at the arbiter's ``on_ready`` hook (lazily
  invalidated: entries die when the task runs, finishes, or its deadline
  changes);
* **posted deadlines** — ``post_deadline(job, t)`` registers an
  engine-level obligation (e.g. an inference request sitting in a server's
  batch queue, not yet materialized as a task) and returns a token;
  ``retire_deadline(job, token)`` withdraws it when the request completes.

From these the arbiter derives each job's **laxity** — earliest deadline
minus now minus a cost estimate (the earliest pending task's ``cost_hint``)
— and changes three things:

1. **EDF grant order** (``_pick_multi``): within each I5 tier
   (spare-lease groups still strictly precede borrowers — non-deadline
   siblings keep their full I5 guarantee), deadline-holding groups are
   granted freed slots earliest-deadline-first, ahead of the tier's
   non-deadline groups; inside a chosen dedicated group the earliest
   pending deadline task is claimed directly, so intra-job order is EDF
   too. Ties and non-deadline groups keep the base largest-spare /
   least-over order.
2. **Urgency-boosted quotas** (``_recompute_quotas``): a job whose laxity
   is at or below ``urgency_threshold`` has its effective share multiplied
   by ``deadline_boost`` (bounded, restored after apportionment), so a
   rebalance under SLO pressure tilts integer quotas toward the pressed
   job. Quotas are re-evaluated at every rebalance and at every urgent
   grant.
3. **Urgent grants**: when a deadline job's laxity goes negative while no
   idle slot exists, the arbiter immediately flags need-resched on the
   lowest-value *borrowed* slot — a preemptive-policy slot running beyond
   its group's quota, preferring non-deadline victims and the most
   over-quota group — and stashes the pressed job's earliest deadline task
   as the slot's redispatch hint (``Scheduler.urgent_preempt``). The
   executor's ``on_urgent`` hook (a watchdog condition-variable kick under
   real threads) services the flag now instead of at the next periodic
   tick. In-lease slots are never victimized (that would break I5's
   spirit), cooperative-policy slots never either (I2).

Zero-cost-when-unused: with no posted deadline and no deadline task
pending, every override falls through to the ``SlotArbiter`` behaviour
after one empty-dict check, and the single-group fast path stays rebound
to the default policy's own methods.
"""

from __future__ import annotations

import itertools
from heapq import heappop, heappush
from typing import Optional

from repro_torch.core.arbiter import ArbiterGroup, SlotArbiter
from repro_torch.core.policies.base import Policy
from repro_torch.core.task import Job, Task, TaskState


class DeadlineArbiter(SlotArbiter):
    """EDF / least-laxity slot arbitration over the ``SlotArbiter`` lease
    machinery (see module docstring for the full contract)."""

    def __init__(self, default_policy: Policy, *,
                 urgency_threshold: float = 0.0,
                 deadline_boost: float = 2.0):
        #: laxity at/below which a job counts as *urgent* (quota boost,
        #: urgent grants). 0.0 = only negative laxity (the ISSUE contract).
        self.urgency_threshold = float(urgency_threshold)
        #: bounded share multiplier applied to urgent jobs at quota
        #: recompute time
        self.deadline_boost = float(deadline_boost)
        #: jid -> heap of (deadline, token) posted obligations
        self._posted: dict[int, list[tuple[float, int]]] = {}
        self._retired: set[int] = set()
        self._token = itertools.count(1)
        #: jid -> heap of (deadline, seq, task) for READY deadline tasks
        #: (lazily invalidated: valid iff still READY with that deadline)
        self._ready_dl: dict[int, list[tuple[float, int, Task]]] = {}
        self._dlseq = itertools.count(1)
        #: urgent grants issued (introspection / benchmarks)
        self.urgent_grants = 0
        super().__init__(default_policy)  # binds entry points (see below)

    # ------------------------------------------------------------------ #
    # deadline bookkeeping
    # ------------------------------------------------------------------ #
    def post_deadline(self, job: Job, deadline: float) -> int:
        """Register an engine-level deadline obligation for ``job`` (e.g.
        a queued inference request); returns a token for ``retire``.
        Fires the urgent path immediately when the new obligation is
        already past its laxity budget."""
        token = next(self._token)
        heap = self._posted.get(job.jid)
        if heap is None:
            heap = self._posted[job.jid] = []
        heappush(heap, (float(deadline), token))
        rec = getattr(self.sched, "_rec", None)
        if rec is not None:
            from repro_torch.core.scheduler import REC_DL_POST
            rec((self.sched.clock(), REC_DL_POST, job.jid, float(deadline)))
        self._maybe_urgent(job)
        return token

    def retire_deadline(self, job: Job, token: int) -> None:
        """Withdraw a posted obligation (request completed/cancelled)."""
        rec = getattr(self.sched, "_rec", None)
        if rec is not None:
            from repro_torch.core.scheduler import REC_DL_RETIRE
            rec((self.sched.clock(), REC_DL_RETIRE, job.jid, token))
        heap = self._posted.get(job.jid)
        if not heap:
            return
        if heap[0][1] == token:
            heappop(heap)
            self._drain_retired(heap)
            if not heap:
                del self._posted[job.jid]
        else:
            self._retired.add(token)

    def _drain_retired(self, heap: list) -> None:
        retired = self._retired
        while heap and heap[0][1] in retired:
            retired.discard(heappop(heap)[1])

    def _active(self) -> bool:
        return bool(self._posted or self._ready_dl)

    def _job_deadline(self, jid: int) -> tuple[Optional[float], float]:
        """(earliest pending deadline, cost estimate) for one job — lazily
        compacting both heaps. The estimate is the earliest READY deadline
        task's ``cost_hint`` (0.0 for posted-only obligations)."""
        best: Optional[float] = None
        est = 0.0
        heap = self._posted.get(jid)
        if heap is not None:
            self._drain_retired(heap)
            if heap:
                best = heap[0][0]
            else:
                del self._posted[jid]
        rheap = self._ready_dl.get(jid)
        if rheap is not None:
            while rheap:
                dl, _, task = rheap[0]
                if task.state is TaskState.READY and task.deadline == dl:
                    if best is None or dl < best:
                        best = dl
                        est = task.cost_hint
                    break
                heappop(rheap)
            if not rheap:
                del self._ready_dl[jid]
        return best, est

    def _earliest_ready_task(self, jid: int) -> Optional[Task]:
        rheap = self._ready_dl.get(jid)
        while rheap:
            dl, _, task = rheap[0]
            if task.state is TaskState.READY and task.deadline == dl:
                return task
            heappop(rheap)
        return None

    def _group_deadline(self, group: ArbiterGroup) -> Optional[float]:
        best: Optional[float] = None
        for jid in group.jids:
            dl, _ = self._job_deadline(jid)
            if dl is not None and (best is None or dl < best):
                best = dl
        return best

    # -- the job-level laxity signal ------------------------------------ #
    def laxity(self, job: Job, now: float) -> Optional[float]:
        """``job``'s deadline headroom: earliest pending deadline − now −
        cost estimate, or None when nothing deadline-bound is pending."""
        dl, est = self._job_deadline(job.jid)
        return None if dl is None else dl - now - est

    def laxity_headroom(self, now: float) -> Optional[float]:
        """Minimum laxity across all jobs with pending deadlines (the
        adaptive slice controller's shrink signal)."""
        if not self._active():
            return None
        best: Optional[float] = None
        for jid in list(self._posted.keys() | self._ready_dl.keys()):
            dl, est = self._job_deadline(jid)
            if dl is None:
                continue
            lax = dl - now - est
            if best is None or lax < best:
                best = lax
        return best

    # ------------------------------------------------------------------ #
    # entry-point hooks (deadline tracking rides on_ready in both the
    # single-group and multi-group binding modes)
    # ------------------------------------------------------------------ #
    def _bind_single(self) -> None:
        super()._bind_single()
        self._inner_on_ready = self.on_ready
        self.on_ready = self._on_ready_deadline

    def _bind_multi(self) -> None:
        super()._bind_multi()
        self._inner_on_ready = self.on_ready
        self.on_ready = self._on_ready_deadline

    def _on_ready_deadline(self, task: Task) -> None:
        self._inner_on_ready(task)
        if task.deadline is None:
            return  # no SLO: exactly the base arbiter's on_ready path
        jid = task.job.jid
        heap = self._ready_dl.get(jid)
        if heap is None:
            heap = self._ready_dl[jid] = []
        heappush(heap, (task.deadline, next(self._dlseq), task))
        self._maybe_urgent(task.job)

    def detach_job(self, job: Job) -> None:
        super().detach_job(job)
        self._posted.pop(job.jid, None)
        self._ready_dl.pop(job.jid, None)

    # ------------------------------------------------------------------ #
    # override point 1: EDF grant order
    # ------------------------------------------------------------------ #
    def _pick_multi(self, slot_id: int) -> Optional[Task]:
        """I5-tiered EDF: spare-lease groups strictly before borrowers
        (the base tier boundary — non-deadline siblings with spare lease
        can never be starved by a borrowing deadline group), but *within*
        each tier deadline-holding groups go earliest-deadline-first,
        ahead of the tier's non-deadline groups, which keep the base
        largest-spare/least-over order among themselves."""
        if not self._active():
            return super()._pick_multi(slot_id)
        candidates = []
        for i, g in enumerate(self._groups):
            if g.policy.has_ready():
                dl = self._group_deadline(g)
                borrow = g.in_use - g.quota
                tier = 0 if borrow < 0 else 1
                if dl is None:
                    candidates.append(((tier, 1, 0.0, borrow, i), g))
                else:
                    candidates.append(((tier, 0, dl, borrow, i), g))
        if not candidates:
            return None
        candidates.sort(key=lambda c: c[0])
        for key, g in candidates:
            if not g.dedicated and len(g.jids) > 1:
                task = self._pick_shared_group(g, slot_id)
            elif key[1] == 0:
                task = self._pick_edf_in_group(g, slot_id)
            else:
                task = g.policy.pick(slot_id)
            if task is not None:
                return task
        return None

    def _pick_edf_in_group(self, g: ArbiterGroup, slot_id: int
                           ) -> Optional[Task]:
        """Intra-group EDF for a dedicated deadline-holding group: claim
        the earliest pending deadline *task* directly (the policy's
        ``remove`` keeps its incremental accounting exact); posted-only
        obligations or an unclaimable task fall back to the policy's own
        pick order."""
        for jid in g.jids:
            task = self._earliest_ready_task(jid)
            if task is not None:
                try:
                    g.policy.remove(task)
                except (KeyError, NotImplementedError):
                    break
                return task
        return g.policy.pick(slot_id)

    # ------------------------------------------------------------------ #
    # override point 2: urgency-boosted quotas
    # ------------------------------------------------------------------ #
    def _recompute_quotas(self) -> None:
        """Largest-remainder apportionment over *urgency-adjusted* shares:
        a job whose laxity is at/below ``urgency_threshold`` weighs
        ``deadline_boost`` times its configured share for this computation
        (shares are restored afterwards — the boost is bounded and
        re-evaluated at every rebalance / urgent grant)."""
        if not self._active() or self.sched is None:
            return super()._recompute_quotas()
        clock = getattr(self.sched, "clock", None)
        if clock is None:
            return super()._recompute_quotas()
        now = clock()
        boosted = []
        for lease in self._leases.values():
            lax = self.laxity(lease.job, now)
            if lax is not None and lax <= self.urgency_threshold:
                boosted.append((lease, lease.share))
                lease.share = lease.share * self.deadline_boost
        try:
            super()._recompute_quotas()
        finally:
            for lease, share in boosted:
                lease.share = share

    # ------------------------------------------------------------------ #
    # the urgent-grant path
    # ------------------------------------------------------------------ #
    def _maybe_urgent(self, job: Job) -> None:
        """Negative laxity + no idle capacity -> flag the lowest-value
        borrowed slot NOW (instead of at the next periodic tick), stash
        the pressed job's earliest deadline task as the redispatch hint,
        and re-tilt quotas under the urgency boost."""
        sched = self.sched
        if sched is None:
            return
        slots = getattr(sched, "_slots", None)
        if slots is None:  # bare stand-in scheduler (benchmarks/tests)
            return
        lease = self.lease_of(job)
        if lease is None:
            return
        now = sched.clock()
        lax = self.laxity(job, now)
        if lax is None or lax > self.urgency_threshold:
            return
        if sched._idle:
            return  # idle capacity exists: the normal fill admits the work
        victim = self._find_victim(lease.group, slots)
        if victim is None:
            return  # no borrowed preemptive slot: EDF order at the next
            #         natural scheduling point is the best I5 allows
        self._recompute_quotas()
        successor = self._earliest_ready_task(job.jid)
        if sched.urgent_preempt(victim, successor):
            self.urgent_grants += 1

    def _find_victim(self, pressed: ArbiterGroup, slots) -> Optional[int]:
        """The lowest-value borrowed slot: running a preemptive-policy
        task (I2) of a group beyond its quota (I5: in-lease grants are
        never revoked for a borrower), preferring victims with no pending
        deadline of their own, then the most over-quota group, then the
        lowest slot id. ``None`` when no slot qualifies."""
        best = None
        best_key = None
        leases = self._leases
        for sid, st in enumerate(slots):
            t = st.running
            if t is None or st.need_resched:
                continue
            vlease = leases.get(t.job.jid)
            vgroup = vlease.group if vlease is not None \
                else self._default_group
            if vgroup is pressed:
                continue
            if not vgroup.policy.preemptive:
                continue  # I2: cooperative slots are never victims
            over = vgroup.in_use - vgroup.quota
            if over <= 0:
                continue  # within lease: not a borrowed slot
            vdl, _ = self._job_deadline(t.job.jid)
            key = (0 if vdl is None else 1, -over, sid)
            if best_key is None or key < best_key:
                best, best_key = sid, key
        return best
