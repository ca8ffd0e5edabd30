"""Job-level slot arbitration — the top half of the two-level scheduler.

The paper coordinates *multi-runtime and multi-process* workloads through
one shared user-space scheduler instance. A single flat policy cannot
express that: a co-located BLAS job wants SCHED_COOP semantics while a
preemptive baseline job wants SCHED_FAIR, and the co-location wins come
from *job-level capacity arbitration*, not from intra-job pick order.

``SlotArbiter`` is that job level. It sits between the ``Scheduler`` (which
owns slots, invariants and scheduling points) and one *intra-job policy per
policy group*:

* every attached job holds a ``SlotLease`` — a nice-weighted proportional
  share of the slots, materialized as an integer ``quota`` by
  largest-remainder apportionment;
* leases are **work-conserving**: a job with ready tasks may *borrow* slots
  beyond its quota, but only when no sibling group with spare lease has
  ready work (invariant I5, tested in tests/test_arbiter.py);
* leases are **elastic**: ``lease.resize(share)`` regrows or reclaims
  capacity at runtime (the job-level generalization of
  ``repro_torch.launch.elastic`` — grants take effect immediately via an idle
  fill, reclaims at the next scheduling point, or at the next preemption
  tick for preemptive intra-job policies);
* jobs attach and detach dynamically (the ``nosv_attach`` analogue): a
  detached job's blocked tasks may later re-register transparently through
  the default group.

Live migration is **any↔any**: every edge of the 3x3 matrix of
(source, destination) group kinds — default / dedicated-cooperative /
dedicated-preemptive — re-homes a *busy* job without draining it.
``attach_job`` promotes out of the default group or, on an
already-dedicated job, performs a live policy swap; ``demote_job``
re-homes a dedicated job back into the default group. In every case the
job's READY tasks are withdrawn from the old policy (``Policy.remove``)
and re-queued exactly once in the new one, while RUNNING tasks keep
their slots, start a fresh slice, and route their next scheduling point
to the new policy. ``detach_job`` remains quiescence-checked: it is
teardown, not migration.

Invariant I5 (grant rule): *a job is never granted a slot beyond its
current lease while a sibling group has ready tasks and spare lease*. The
arbiter enforces it structurally — borrowing grants are only reached after
every under-quota group has declined the slot.

Fast path: with a single policy group (the common single-runtime case) the
arbiter rebinds its scheduling-point entry points to the default policy's
bound methods, so the two-level design costs nothing until a second
runtime actually attaches.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from repro_torch.core.lease import LeaseTable
from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.policies.sched_fair import nice_to_weight
from repro_torch.core.task import Job, Task, TaskState

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.scheduler import Scheduler


class ArbiterError(RuntimeError):
    pass


class ArbiterGroup:
    """One intra-job policy instance plus the jobs it multiplexes.

    Jobs attached *with* a dedicated policy form a one-job group; jobs
    registered without one share the default group (and its policy does its
    own intra-group multiplexing, e.g. SCHED_COOP's job rotation). Lease
    enforcement is at group granularity: ``quota``/``in_use`` aggregate the
    member leases.
    """

    __slots__ = ("policy", "jids", "quota", "in_use", "dedicated")

    def __init__(self, policy: Policy, *, dedicated: bool):
        self.policy = policy
        self.jids: set[int] = set()
        self.quota = 0
        self.in_use = 0
        self.dedicated = dedicated

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"ArbiterGroup({self.policy.name} jobs={len(self.jids)} "
                f"{self.in_use}/{self.quota})")


class SlotLease:
    """A job's proportional claim on the slot pool.

    ``share`` is a relative weight (defaults to the nice-derived weight, so
    the paper's gateway-nice-0 / server-nice-20 setup maps directly onto
    leases); ``quota`` is the integer slot entitlement the arbiter derives
    from it; ``in_use`` counts the job's currently running tasks.
    """

    __slots__ = ("job", "arbiter", "group", "share", "quota", "in_use")

    def __init__(self, job: Job, arbiter: "SlotArbiter", group: ArbiterGroup,
                 share: float):
        self.job = job
        self.arbiter = arbiter
        self.group = group
        self.share = share
        self.quota = 0
        self.in_use = 0

    def resize(self, share: float) -> "SlotLease":
        """Elastic grant/reclaim: change this job's share at runtime.

        Growing takes effect immediately (idle slots are refilled under the
        new quotas); shrinking is reclaimed at the job's next scheduling
        point — or next preemption tick when its policy is preemptive (the
        lease-revocation scheduling point). SCHED_COOP jobs are never
        preempted for reclaim (I2).
        """
        self.arbiter._resize(self, share)
        return self

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"SlotLease({self.job.name} share={self.share:.1f} "
                f"{self.in_use}/{self.quota})")


def _job_share(job: Job, share: Optional[float]) -> float:
    if share is not None:
        s = float(share)
    elif job.share is not None:
        s = float(job.share)
    else:
        s = nice_to_weight(job.nice)
    if s < 0:
        raise ArbiterError(f"negative share {s} for {job}")
    return s


class SlotArbiter:
    """Two-level scheduler front: routes scheduling points to per-group
    intra-job policies under lease arbitration.

    The ``Scheduler`` drives it through the same entry points as a flat
    ``Policy`` (pick / on_ready / on_run / on_stop / should_preempt /
    has_ready / ready_count); job lifecycle goes through ``attach_job`` /
    ``detach_job`` / ``on_job``.

    **Extending the grant order**: subclasses customize job-level
    arbitration by overriding ``_pick_multi`` (which job's policy gets a
    freed slot) and ``_recompute_quotas`` (how shares materialize into
    integer quotas). The worked example is
    ``repro_torch.core.deadline.DeadlineArbiter``: it reorders ``_pick_multi``
    candidates *within* each I5 tier by earliest deadline (spare-lease
    groups still strictly precede borrowers, so non-deadline siblings keep
    their I5 guarantee), boosts the effective share of deadline-pressed
    jobs in ``_recompute_quotas``, and adds an urgent-grant path that
    flags need-resched on the lowest-value borrowed slot the moment a
    deadline job's laxity goes negative. Overrides only see the
    multi-group path: with a single policy group the entry points stay
    rebound to the default policy's own methods (the zero-overhead fast
    path below), so deadline machinery costs nothing until a second group
    — or a deadline — actually shows up.
    """

    def __init__(self, default_policy: Policy):
        self.sched: Optional["Scheduler"] = None
        self._default = default_policy
        self._default_group = ArbiterGroup(default_policy, dedicated=False)
        self._groups: list[ArbiterGroup] = [self._default_group]
        #: the shared lease/quota machinery (repro_torch.core.lease) — the same
        #: table class the node-level broker apportions processes with
        self._table = LeaseTable()
        #: jid -> lease, attach order (the table's own dict, bound once so
        #: the multi-group scheduling points skip an attribute hop)
        self._leases: dict[int, SlotLease] = self._table.entries
        self._bind_single()

    # ------------------------------------------------------------------ #
    # scheduler binding (Policy.attach shape)
    # ------------------------------------------------------------------ #
    def attach(self, sched) -> None:
        self.sched = sched
        self._table.capacity = sched.topology.n_slots
        self._default.attach(sched)
        self._recompute_quotas()

    def set_capacity(self, n_slots: int) -> None:
        """Re-apportion the leases over a new effective slot pool (elastic
        slot parking: a broker revoke shrinks the process's width, and the
        in-process quotas must track the *active* pool, not the topology)."""
        self._table.capacity = int(n_slots)
        self._recompute_quotas()

    @property
    def default_policy(self) -> Policy:
        return self._default

    @property
    def multi(self) -> bool:
        return len(self._groups) > 1

    def groups(self) -> tuple[ArbiterGroup, ...]:
        return tuple(self._groups)

    def leases(self) -> tuple[SlotLease, ...]:
        return tuple(self._leases.values())

    def describe(self) -> str:
        if not self.multi:
            return self._default.name
        names = "+".join(g.policy.name for g in self._groups if g.jids)
        return f"arbiter[{names}]"

    def policy_of(self, job: Job) -> Policy:
        lease = job.lease
        if lease is not None and lease.arbiter is self:
            return lease.group.policy
        return self._default

    def lease_of(self, job: Job) -> Optional[SlotLease]:
        lease = job.lease
        return lease if lease is not None and lease.arbiter is self else None

    def laxity_headroom(self, now: float) -> Optional[float]:
        """Minimum deadline laxity across attached jobs, or ``None`` when
        nothing deadline-bound is pending. The base arbiter tracks no
        deadlines — the adaptive slice controller and the watchdog read
        this through one virtual call that stays a constant ``None`` here
        (``DeadlineArbiter`` overrides it)."""
        return None

    def claim(self, task: Task) -> bool:
        """Withdraw a specific READY ``task`` from its policy queue for an
        urgent-grant redispatch (``Scheduler._fill`` consumes the slot's
        successor hint through this, skipping the full pick while keeping
        the policy's incremental accounting exact). Returns False when the
        task cannot be claimed — not attached here, not queued, or its
        policy lacks ``remove`` — in which case the caller falls back to a
        normal pick."""
        if task.state is not TaskState.READY:
            return False
        lease = self.lease_of(task.job)
        policy = lease.group.policy if lease is not None else self._default
        try:
            policy.remove(task)
        except (KeyError, NotImplementedError):
            return False
        return True

    def lease_snapshot(self) -> dict:
        return {
            l.job.name: {
                "share": l.share,
                "quota": l.quota,
                "in_use": l.in_use,
                "policy": l.group.policy.name,
            }
            for l in self._leases.values()
        }

    # ------------------------------------------------------------------ #
    # job lifecycle (nosv_attach / nosv_detach analogues)
    # ------------------------------------------------------------------ #
    def on_job(self, job: Job) -> None:
        """Implicit registration: unknown jobs join the default group."""
        if job.jid not in self._leases:
            self.attach_job(job)

    def attach_job(self, job: Job, *, policy: Optional[Policy] = None,
                   share: Optional[float] = None) -> SlotLease:
        """Register ``job``, optionally with its own intra-job policy.

        With ``policy=None`` the job joins the shared default group (the
        flat pre-arbiter behaviour). With a dedicated policy the job forms
        its own group — this is how one SCHED_COOP job co-locates with a
        SCHED_FAIR sibling. A job already attached is *re-homed live*:
        out of the default group (promotion) or out of its current
        dedicated group (a **live policy swap** — the old group is torn
        down and the job's work moves to the fresh policy instance
        without quiescence). READY tasks are withdrawn from the old
        policy (``Policy.remove``) and re-queued — exactly once each — in
        the new group's policy; RUNNING tasks keep their slots, start a
        fresh slice, and route their next scheduling point to the new
        policy; BLOCKED tasks route there on wakeup. No dispatch is lost
        or duplicated: a task is either withdrawn before it could be
        picked or it was already dispatched, never both.
        """
        existing = self._leases.get(job.jid)
        if existing is not None and policy is None:
            raise ArbiterError(
                f"{job} already attached; use lease.resize to change its "
                "share, attach_job(policy=...) to swap its policy live, or "
                "demote_job to re-home it into the default group"
            )
        if policy is not None and (policy is self._default or any(
            policy is g.policy for g in self._groups
        )):
            raise ArbiterError(
                "dedicated policy instance is already in use by another "
                "group (or is the job's current policy); pass a fresh "
                "instance per attach"
            )
        share_val = _job_share(job, share)  # validate BEFORE any teardown:
        # a failed attach must leave the job's queue/lease state untouched
        if policy is not None:
            # user-supplied policy hooks may raise (custom policies):
            # run them BEFORE the withdrawal too, or the migrated tasks
            # would be left queued nowhere
            if self.sched is not None:
                policy.attach(self.sched)
            policy.on_job(job)

            def make_group() -> ArbiterGroup:
                group = ArbiterGroup(policy, dedicated=True)
                self._groups.append(group)
                return group
        else:
            self._default.on_job(job)

            def make_group() -> ArbiterGroup:
                return self._default_group
        return self._rehome(job, existing, make_group, share_val)

    def demote_job(self, job: Job, *, share: Optional[float] = None
                   ) -> SlotLease:
        """Live dedicated→default re-homing (the reverse of promotion).

        The job's dedicated lease and policy group are released and its
        work moves into the shared default group *without quiescence*:
        READY tasks are withdrawn from the dedicated policy and re-queued
        exactly once in the default policy; RUNNING tasks keep their
        slots, start a fresh slice, and route their next scheduling point
        to the default policy. The returned lease is the job's new
        default-group membership (``share`` defaults to the job's
        explicit share or its nice-derived weight, like any implicit
        registration). Use ``detach_job`` — quiescence-checked — for true
        teardown.
        """
        existing = self._leases.get(job.jid)
        if existing is None:
            raise ArbiterError(f"{job} is not attached")
        if not existing.group.dedicated:
            raise ArbiterError(
                f"{job} already runs in the default group; demote_job only "
                "re-homes dedicated jobs"
            )
        share_val = _job_share(job, share)
        # refuse an unwithdrawable source BEFORE registering the job with
        # the default policy: a failed demote must not leave a phantom
        # job entry in its rotation (attach_job needs no such pre-check —
        # its failed fresh policy instance is simply discarded)
        self._check_withdrawable(job, existing.group.policy)
        self._default.on_job(job)  # before withdrawal: must not raise later

        def make_group() -> ArbiterGroup:
            return self._default_group

        return self._rehome(job, existing, make_group, share_val)

    def _rehome(self, job: Job, existing: Optional[SlotLease],
                make_group, share_val: float) -> SlotLease:
        """Shared migration tail of attach_job/demote_job: withdraw the
        job's queued work from its old group (if any), bind it to the
        group built by ``make_group``, re-queue the withdrawn READY tasks
        exactly once, and hand the new policy the job's RUNNING tasks as
        running-since-now."""
        migrated: list[Task] = []
        if existing is not None:
            migrated = self._withdraw_ready(job, existing.group.policy)
            self._release_lease(job)
        group = make_group()
        group.jids.add(job.jid)
        lease = SlotLease(job, self, group, share_val)
        self._leases[job.jid] = lease
        job.lease = lease
        for t in migrated:  # re-home the withdrawn READY tasks, once each
            group.policy.on_ready(t)
        clock = getattr(self.sched, "clock", None)  # absent on bare stand-ins
        now = clock() if clock is not None else 0.0
        for t in job.tasks:
            # RUNNING tasks keep their slots but must be known to the new
            # policy as running-since-now (a fresh slice), or a preemptive
            # policy could never slice-expire them
            if t.state is TaskState.RUNNING and t.slot is not None:
                self._restart_slice(t, now)
                group.policy.on_run(t, t.slot, now)
        self._rebalance()
        return lease

    def _restart_slice(self, task: Task, now: float) -> None:
        """Charge a re-homed RUNNING task's accrued run time and restart
        its slot's slice clock: the new policy's first ``on_stop`` must
        see only post-migration elapsed time (on_run promised it a fresh
        slice), and the old policy — possibly already torn down — keeps
        the pre-migration accrual out of the new one's accounting."""
        slots = getattr(self.sched, "_slots", None)
        if slots is None:  # bare stand-in scheduler (benchmarks/tests)
            return
        st = slots[task.slot]
        elapsed = now - st.run_started
        if elapsed > 0.0:
            task.stats.run_time += elapsed
            task.job.service_time += elapsed
            st.run_started = now

    def _withdraw_ready(self, job: Job, policy: Policy) -> list[Task]:
        """Surrender ``job``'s queued tasks from ``policy`` (live migration:
        promotion, policy swap, and demotion all start here).
        Every READY task of an attached job is queued in its group's policy,
        so the withdrawal is total: afterwards the policy holds none of the
        job's work and its incremental accounting matches a never-admitted
        pool."""
        ready = self._check_withdrawable(job, policy)
        for t in ready:
            policy.remove(t)
        return ready

    def _check_withdrawable(self, job: Job, policy: Policy) -> list[Task]:
        """Mutation-free precondition of a live withdrawal: returns the
        job's READY tasks, raising if ``policy`` cannot surrender them —
        checked BEFORE touching any queue (or registering the job
        elsewhere), so a refused migration leaves every policy's state
        untouched."""
        ready = [t for t in job.tasks if t.state is TaskState.READY]
        if ready and type(policy).remove is Policy.remove:
            raise ArbiterError(
                f"{policy.name} does not implement Policy.remove: cannot "
                f"live-migrate {job}'s queued tasks; attach before "
                "submitting work or implement remove()"
            )
        return ready

    def detach_job(self, job: Job) -> None:
        """Unregister ``job`` and release its lease (dynamic re-registration:
        a later submit — or a blocked task waking up — re-attaches the job
        to the default group)."""
        if job.jid not in self._leases:
            raise ArbiterError(f"{job} is not attached")
        self._require_quiescent(job, "detach")
        self._release_lease(job)
        self._rebalance()

    def _release_lease(self, job: Job) -> ArbiterGroup:
        """Tear down ``job``'s lease binding (shared by detach and the live
        re-home path of attach); returns the group the job left. The caller
        rebalances."""
        lease = self._leases.pop(job.jid)
        job.lease = None
        group = lease.group
        group.jids.discard(job.jid)
        if group.dedicated:
            self._groups.remove(group)
        else:
            self._default.on_job_detach(job)
        return group

    def _require_quiescent(self, job: Job, what: str) -> None:
        busy = [t for t in job.tasks
                if t.state in (TaskState.READY, TaskState.RUNNING)]
        if busy:
            shown = ", ".join(
                f"{t.name}#{t.tid}={t.state.value}" for t in busy[:8])
            more = f", +{len(busy) - 8} more" if len(busy) > 8 else ""
            raise ArbiterError(
                f"cannot {what}: {job.name}#{job.jid} still has {len(busy)} "
                f"READY/RUNNING task(s): {shown}{more} — detach is teardown "
                "only; attach_job(policy=...)/demote_job re-home a busy job "
                "live"
            )

    # ------------------------------------------------------------------ #
    # lease bookkeeping
    # ------------------------------------------------------------------ #
    def _resize(self, lease: SlotLease, share: float) -> None:
        # identity, not jid membership: a live swap/demote supersedes the
        # job's lease object, and a resize of the dead one must fail loud
        # rather than write a share no quota computation will ever read
        if lease.arbiter is not self \
                or self._leases.get(lease.job.jid) is not lease:
            raise ArbiterError(f"{lease} is no longer attached "
                               "(detached, or superseded by a re-home)")
        share = float(share)
        if share < 0:
            raise ArbiterError(f"negative share {share}")
        sched = self.sched
        lock = getattr(sched, "_lock", None)
        if lock is not None:
            with lock:
                lease.share = share
                rec = getattr(sched, "_rec", None)
                if rec is not None:
                    from repro_torch.core.scheduler import REC_RESIZE
                    rec((sched.clock(), REC_RESIZE, lease.job.jid, share))
                self._recompute_quotas()
                # grant path: newly entitled capacity admits queued work now
                sched._fill_idle_slots(sched.clock())
        else:
            lease.share = share
            self._recompute_quotas()

    def _rebalance(self) -> None:
        self._recompute_quotas()
        self._resync_in_use()
        if self.multi:
            self._bind_multi()
        else:
            self._bind_single()

    def _recompute_quotas(self) -> None:
        """Largest-remainder apportionment of the slot pool by share —
        delegated to the shared ``LeaseTable`` (repro_torch.core.lease), then
        aggregated per policy group."""
        for g in self._groups:
            g.quota = 0
        self._table.recompute()
        for lease in self._leases.values():
            lease.group.quota += lease.quota

    def _resync_in_use(self) -> None:
        """Recount running tasks per lease/group from the slot table
        (attach/detach can happen while sibling jobs are mid-flight)."""
        for l in self._leases.values():
            l.in_use = 0
        for g in self._groups:
            g.in_use = 0
        slots = getattr(self.sched, "_slots", None)
        if not slots:
            return
        for st in slots:
            t = st.running
            if t is None:
                continue
            lease = self._leases.get(t.job.jid)
            if lease is not None:
                lease.in_use += 1
                lease.group.in_use += 1

    # ------------------------------------------------------------------ #
    # scheduling-point routing
    # ------------------------------------------------------------------ #
    def _bind_single(self) -> None:
        """Single policy group: rebind the hot entry points straight to the
        default policy's bound methods — near-zero two-level overhead (the
        PR 1 fast-path numbers are gated on this, benchmarks/sched_ops.py).
        ``on_ready`` keeps a thin wrapper: it is the wakeup path, so it must
        re-register detached jobs whose BLOCKED tasks resurface — otherwise
        a leaseless task could reach a later multi-group transition."""
        p = self._default
        self.pick = p.pick
        self.on_ready = self._on_ready_single
        self.on_run = p.on_run
        self.on_stop = p.on_stop
        self.should_preempt = p.should_preempt
        self.has_ready = p.has_ready
        self.ready_count = p.ready_count

    def _bind_multi(self) -> None:
        self.pick = self._pick_multi
        self.on_ready = self._on_ready_multi
        self.on_run = self._on_run_multi
        self.on_stop = self._on_stop_multi
        self.should_preempt = self._should_preempt_multi
        self.has_ready = self._has_ready_multi
        self.ready_count = self._ready_count_multi

    def _pick_multi(self, slot_id: int) -> Optional[Task]:
        """Grant the slot under the lease rule (I5).

        Candidate order: groups holding spare lease first (largest spare
        wins, ties by attach order), then — work-conserving borrowing —
        groups already at/over quota, least-over first. This is exactly
        ``repro_torch.core.lease.borrow_order`` — the shared I5 order the node
        broker applies at process granularity — inlined into the filter
        pass because this runs per pick (lockstep-asserted equivalent in
        tests/test_lease_table.py). A borrowing grant is therefore only
        reachable after every spare-lease group declined, which is
        exactly the I5 grant rule.
        """
        candidates = []
        for i, g in enumerate(self._groups):
            if g.policy.has_ready():
                candidates.append((g.in_use - g.quota, i, g))
        if not candidates:
            return None
        candidates.sort()
        for _, _, g in candidates:
            if not g.dedicated and len(g.jids) > 1:
                task = self._pick_shared_group(g, slot_id)
            else:
                task = g.policy.pick(slot_id)
            if task is not None:
                return task
        return None

    def _pick_shared_group(self, g: ArbiterGroup, slot_id: int
                           ) -> Optional[Task]:
        """Per-job lease enforcement inside a shared (default) group: the
        job-granular I5 analogue — no member job is granted a slot beyond
        its own lease while a sibling member has ready tasks and spare
        lease. When that situation holds, the grant is restricted to the
        under-lease members via a job-filtered pick; otherwise the group's
        policy picks freely (work-conserving borrowing between members).
        """
        policy = g.policy
        try:
            allowed: Optional[set[int]] = None
            over = False
            leases = self._leases
            for jid in g.jids:
                lease = leases[jid]
                if not policy.ready_count_of(lease.job):
                    continue
                if lease.in_use < lease.quota:
                    if allowed is None:
                        allowed = set()
                    allowed.add(jid)
                else:
                    over = True
            if allowed and over:
                task = policy.pick_filtered(slot_id, allowed)
                if task is not None:
                    return task
        except NotImplementedError:
            # legacy custom policy without the job-filtered surface: keep
            # the pre-PR-3 group-granular behaviour instead of crashing
            pass
        return policy.pick(slot_id)

    def _on_ready_single(self, task: Task) -> None:
        lease = task.job.lease
        if lease is None or lease.arbiter is not self:
            self.on_job(task.job)  # dynamic re-registration on wakeup
        self._default.on_ready(task)

    def _on_ready_multi(self, task: Task) -> None:
        job = task.job
        lease = job.lease
        if lease is None or lease.arbiter is not self:
            self.on_job(job)  # dynamic re-registration (detached job woke up)
            lease = job.lease
        lease.group.policy.on_ready(task)

    def _on_run_multi(self, task: Task, slot_id: int, now: float) -> None:
        lease = task.job.lease
        lease.in_use += 1
        lease.group.in_use += 1
        lease.group.policy.on_run(task, slot_id, now)

    def _on_stop_multi(self, task: Task, slot_id: int, now: float,
                       elapsed: float, reason: StopReason) -> None:
        lease = task.job.lease
        lease.in_use -= 1
        lease.group.in_use -= 1
        lease.group.policy.on_stop(task, slot_id, now, elapsed, reason)

    def _should_preempt_multi(self, task: Task, slot_id: int,
                              now: float) -> bool:
        group = task.job.lease.group
        policy = group.policy
        if not policy.preemptive:
            return False  # I2: cooperative jobs are never preempted
        if policy.should_preempt(task, slot_id, now):
            return True
        # lease-revocation scheduling point: running beyond quota while a
        # sibling group holds spare lease and ready work
        if group.in_use > group.quota:
            for h in self._groups:
                if h is not group and h.in_use < h.quota and h.policy.has_ready():
                    return True
        return False

    def _has_ready_multi(self) -> bool:
        for g in self._groups:
            if g.policy.has_ready():
                return True
        return False

    def _ready_count_multi(self) -> int:
        return sum(g.policy.ready_count() for g in self._groups)
