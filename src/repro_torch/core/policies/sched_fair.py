"""SCHED_FAIR — EEVDF-like preemptive baseline (the Linux stand-in, §2.1).

Earliest Eligible Virtual Deadline First [Stoica & Abdel-Wahab '95], the
Linux default since 6.6:

* each task accrues *virtual runtime* at rate 1/weight (weight from nice);
* a task is *eligible* when its vruntime is not ahead of the pool's virtual
  time V (its lag is >= 0);
* among eligible tasks, pick the earliest virtual deadline
  ``vd = vruntime + slice/weight``;
* running tasks are preempted when their slice expires (time quantum),
  regardless of what they are doing — this is precisely the behaviour that
  produces Lock-Holder/Lock-Waiter Preemption under oversubscription.

Placement is affinity-blind by design: like the kernel's fair class with
regular load balancing, tasks migrate freely between slots, modelling the
"OS lack of application awareness" the paper discusses.

Implementation: a task's vruntime — and therefore its virtual deadline —
is frozen while it sits in the ready pool (it only advances on ``on_stop``,
and ``on_ready`` clamps once at admission). That makes every per-pick
quantity incrementally maintainable:

* the pool virtual time V = sum(w·vr)/sum(w) is kept as two running sums,
  reset to exact zero whenever the pool drains and resynced exactly at
  every heap compaction, so incremental float drift is bounded to a few
  hundred add/subtract ops — orders of magnitude below the 1e-12
  eligibility slack that both implementations share;
* candidates live in deadline-keyed heaps — one global, plus one per
  ``last_slot`` bucket for the wake-affinity preference — with lazy
  invalidation: picking a task merely drops its entry token, stale
  entries are discarded when they surface at a heap top, and the heaps
  are compacted (rebuilt from live entries) once stale entries dominate,
  keeping memory O(live);
* the ready-pool minimum vruntime (the ``min_vruntime`` floor update in
  ``on_stop``) comes from a vruntime-keyed heap with the same lazy scheme.

Tie-breaks are by admission order (a monotone sequence number), which is
exactly the list order the original O(n²) scan used, so pick order — and
therefore every simulated makespan — is preserved (property-tested in
lockstep against the reference implementation, and pinned on the fig3
benchmark cells).
"""

from __future__ import annotations

from heapq import heapify, heappop, heappush
from typing import Optional

from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.task import Task

DEFAULT_SLICE = 0.003  # ~3 ms, Linux base_slice ballpark

_ELIGIBLE_EPS = 1e-12  # slack on the vr <= V eligibility comparison


def nice_to_weight(nice: int) -> float:
    """Linux sched_prio_to_weight spacing: ~+10% CPU per -1 nice."""
    return 1024.0 / (1.25 ** nice)


class SchedFair(Policy):
    name = "SCHED_FAIR"
    preemptive = True

    def __init__(self, *, slice_s: float = DEFAULT_SLICE):
        super().__init__()
        self.slice_s = slice_s
        self.tick_interval = slice_s
        self._vruntime: dict[int, float] = {}
        self._run_started: dict[int, float] = {}
        self._min_vruntime = 0.0
        # -- incremental ready-pool state -------------------------------- #
        self._nready = 0
        self._wsum = 0.0     # sum of weights over the ready pool
        self._wvsum = 0.0    # sum of weight*vruntime over the ready pool
        self._seq = 0        # admission counter: heap tie-break = FIFO order
        #: tid -> live entry seq; an entry (key, seq, task) is stale unless
        #: ``_live.get(task.tid) == seq`` (lazy invalidation)
        self._live: dict[int, int] = {}
        #: jid -> READY tasks of that job in the pool (job-filtered picks)
        self._per_job: dict[int, int] = {}
        self._dl_all: list[tuple[float, int, Task]] = []
        #: last_slot (int | None) -> deadline heap of that affinity bucket
        self._dl_by_slot: dict[Optional[int], list[tuple[float, int, Task]]] = {}
        self._vr_heap: list[tuple[float, int, Task]] = []

    # -- helpers ---------------------------------------------------------- #
    def _w(self, task: Task) -> float:
        return nice_to_weight(task.job.nice)

    def _vr(self, task: Task) -> float:
        return self._vruntime.setdefault(task.tid, self._min_vruntime)

    def _deadline(self, task: Task) -> float:
        return self._vr(task) + self.slice_s / self._w(task)

    # -- heap scans (lazy invalidation) ----------------------------------- #
    def _min_eligible(self, heap, vmax: float):
        """Smallest live (deadline, seq) entry whose vruntime <= vmax.

        Stale entries surfacing at the top are dropped for good; live but
        ineligible entries are popped into a side buffer and pushed back
        (rare: deadline order ~ vruntime order unless weights diverge).
        """
        live = self._live
        vruntime = self._vruntime
        buf = None
        found = None
        while heap:
            entry = heap[0]
            task = entry[2]
            if live.get(task.tid) != entry[1]:
                heappop(heap)
                continue
            if vruntime[task.tid] <= vmax:
                found = entry
                break
            if buf is None:
                buf = []
            buf.append(heappop(heap))
        if buf is not None:
            for entry in buf:
                heappush(heap, entry)
        return found

    def _live_top(self, heap):
        """Smallest live (deadline, seq) entry, ignoring eligibility."""
        live = self._live
        while heap:
            entry = heap[0]
            if live.get(entry[2].tid) == entry[1]:
                return entry
            heappop(heap)
        return None

    def _remove(self, entry) -> Task:
        """Invalidate a picked task's entries and update the pool sums."""
        task = entry[2]
        del self._live[task.tid]
        jid = task.job.jid
        left = self._per_job[jid] - 1
        if left:
            self._per_job[jid] = left
        else:
            del self._per_job[jid]
        w = self._w(task)
        self._nready -= 1
        if self._nready == 0:
            # exact reset: no float residue survives an empty pool
            self._wsum = 0.0
            self._wvsum = 0.0
            self._dl_all.clear()
            self._dl_by_slot.clear()
            self._vr_heap.clear()
        else:
            self._wsum -= w
            self._wvsum -= self._vruntime[task.tid] * w
        return task

    def _compact(self) -> None:
        """Rebuild the heaps from live entries and resync the pool sums.

        Triggered when stale entries dominate (amortized O(1) per op): this
        bounds heap memory to O(live) even when the pool never drains, and
        squashes any float drift the incremental sums picked up since the
        last exact reset.
        """
        live = self._live
        entries = [e for e in self._dl_all if live.get(e[2].tid) == e[1]]
        heapify(entries)
        self._dl_all = entries
        # last_slot is frozen while a task is in the pool, so the bucket
        # key at admission is still correct here
        buckets: dict = {}
        for e in entries:
            buckets.setdefault(e[2].last_slot, []).append(e)
        for b in buckets.values():
            heapify(b)
        self._dl_by_slot = buckets
        vrs = [e for e in self._vr_heap if live.get(e[2].tid) == e[1]]
        heapify(vrs)
        self._vr_heap = vrs
        wsum = 0.0
        wvsum = 0.0
        vruntime = self._vruntime
        for e in entries:
            w = self._w(e[2])
            wsum += w
            wvsum += vruntime[e[2].tid] * w
        self._wsum = wsum
        self._wvsum = wvsum

    def on_job_detach(self, job) -> None:
        # No READY tasks remain by contract (quiescent detach, or a live
        # re-home that already withdrew them via remove()), so dropping
        # the per-task accounting cannot orphan a queued entry. Without
        # this the default group would leak vruntime entries for every
        # job that ever promoted out of it (swap-churn workloads).
        for t in job.tasks:
            self._vruntime.pop(t.tid, None)
            self._run_started.pop(t.tid, None)

    # -- policy ----------------------------------------------------------- #
    def on_ready(self, task: Task) -> None:
        # Sleepers rejoin at max(own vruntime, pool floor): they don't hoard
        # lag while blocked (Linux place_entity behaviour, simplified).
        vr = max(self._vr(task), self._min_vruntime)
        self._vruntime[task.tid] = vr
        if len(self._dl_all) > 64 and len(self._dl_all) > 4 * self._nready:
            self._compact()
        w = self._w(task)
        seq = self._seq
        self._seq = seq + 1
        self._live[task.tid] = seq
        entry = (vr + self.slice_s / w, seq, task)
        heappush(self._dl_all, entry)
        bucket = self._dl_by_slot.get(task.last_slot)
        if bucket is None:
            bucket = self._dl_by_slot[task.last_slot] = []
        heappush(bucket, entry)
        heappush(self._vr_heap, (vr, seq, task))
        self._nready += 1
        jid = task.job.jid
        self._per_job[jid] = self._per_job.get(jid, 0) + 1
        self._wsum += w
        self._wvsum += vr * w

    def remove(self, task: Task) -> None:
        """Detach a READY task (live migration): same sum/heap maintenance
        as a pick-removal — the heap tokens go stale and are dropped
        lazily, so incremental V stays exact vs the reference policy."""
        if self._live.get(task.tid) is None:
            raise KeyError(f"{task} is not queued in {self.name}")
        self._remove((0.0, 0, task))

    def pick(self, slot_id: int) -> Optional[Task]:
        if self._nready == 0:
            return None
        # V = weighted average vruntime over the ready pool
        vmax = self._wvsum / self._wsum + _ELIGIBLE_EPS
        # wake affinity (select_task_rq prev-CPU preference): among the
        # eligible set, prefer tasks that last ran on this slot (or nowhere)
        local_a = self._dl_by_slot.get(slot_id)
        local_b = self._dl_by_slot.get(None)
        e_a = self._min_eligible(local_a, vmax) if local_a else None
        e_b = self._min_eligible(local_b, vmax) if local_b else None
        best = e_a if e_b is None or (e_a is not None and e_a < e_b) else e_b
        if best is None:
            best = self._min_eligible(self._dl_all, vmax)
        if best is None:
            # nothing eligible: fall back to the whole pool, local first
            e_a = self._live_top(local_a) if local_a else None
            e_b = self._live_top(local_b) if local_b else None
            best = e_a if e_b is None or (e_a is not None and e_a < e_b) else e_b
            if best is None:
                best = self._live_top(self._dl_all)
        assert best is not None  # _nready > 0 implies a live entry exists
        return self._remove(best)

    def pick_filtered(self, slot_id: int, allowed_jids) -> Optional[Task]:
        """EEVDF pick restricted to jobs in ``allowed_jids``.

        Scans the global deadline heap in order (heap pops come sorted):
        the first live allowed *eligible* entry wins; the first live
        allowed entry seen is the min-deadline fallback when nothing
        allowed is eligible. Popped live entries are pushed back. The
        wake-affinity preference is skipped on this path — it only runs
        under per-job lease enforcement, where fairness of the restricted
        grant matters more than slot warmth.
        """
        if self._nready == 0:
            return None
        vmax = self._wvsum / self._wsum + _ELIGIBLE_EPS
        heap = self._dl_all
        live = self._live
        vruntime = self._vruntime
        buf: list = []
        chosen = None
        fallback = None
        while heap:
            entry = heappop(heap)
            if live.get(entry[2].tid) != entry[1]:
                continue  # stale: dropped for good
            buf.append(entry)
            if entry[2].job.jid not in allowed_jids:
                continue
            if vruntime[entry[2].tid] <= vmax:
                chosen = entry
                break
            if fallback is None:
                fallback = entry
        if chosen is None:
            chosen = fallback
        for entry in buf:
            if entry is not chosen:
                heappush(heap, entry)
        if chosen is None:
            return None
        return self._remove(chosen)

    def on_run(self, task: Task, slot_id: int, now: float) -> None:
        self._run_started[task.tid] = now

    def on_stop(
        self, task: Task, slot_id: int, now: float, elapsed: float, reason: StopReason
    ) -> None:
        vr = self._vr(task) + elapsed / self._w(task)
        self._vruntime[task.tid] = vr
        if self._nready:
            top = self._live_top(self._vr_heap)
            assert top is not None
            self._min_vruntime = max(self._min_vruntime, top[0])
        else:
            self._min_vruntime = max(self._min_vruntime, vr)

    def should_preempt(self, task: Task, slot_id: int, now: float) -> bool:
        if self._nready == 0:
            return False  # nothing to run instead: keep going
        ran = now - self._run_started.get(task.tid, now)
        return ran >= self.slice_s / self._w(task)

    def slice_for(self, task: Task) -> float:
        # the effective slice should_preempt compares against: weight-
        # scaled, so a nice-0 task's self-expiry matches its eviction time
        return self.slice_s / self._w(task)

    def ready_count(self) -> int:
        return self._nready

    def ready_count_of(self, job) -> int:
        return self._per_job.get(job.jid, 0)
