"""SCHED_COOP — the paper's default cooperative policy (§3, §4.1).

Behaviour reproduced from the paper:

* Threads run uninterrupted with fixed single-slot affinity until the
  *application* makes them wait; SCHED_COOP never preempts (I2).
* A previously blocked task is queued in a **per-job, per-slot FIFO** keyed
  by the last slot it ran on.
* Placement search order: idle slot matching affinity → same locality
  domain (NUMA / ICI neighborhood) → anywhere.
* A per-job quantum (default 20 ms), **evaluated only at scheduling
  points**, rotates service between jobs; like nOS-V, the rotation is
  work-conserving: if the current job has nothing ready for a slot, tasks
  of other jobs are served rather than idling the slot.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Optional

from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.task import Job, Task

DEFAULT_QUANTUM = 0.020  # 20 ms, the paper's default


class _JobQueues:
    """Per-job ready queues: one FIFO per preferred slot + one unaffine FIFO."""

    __slots__ = ("job", "per_slot", "unaffine", "size")

    def __init__(self, job: Job):
        self.job = job
        self.per_slot: dict[int, Deque[Task]] = {}
        self.unaffine: Deque[Task] = deque()
        self.size = 0

    def push(self, task: Task) -> None:
        # A yielding task goes to the back of the global order (nosv_yield):
        # re-enqueueing it by affinity would let it get re-picked instantly,
        # defeating the §5.2 busy-wait adaptation.
        if task._yielded:
            task._yielded = False
            self.unaffine.append(task)
        elif task.last_slot is None:
            self.unaffine.append(task)
        else:
            self.per_slot.setdefault(task.last_slot, deque()).append(task)
        self.size += 1

    def pop_for(self, slot_id: int, neighbors) -> Optional[Task]:
        """Affinity → unaffine (new work) → same domain → anywhere (§4.1)."""
        q = self.per_slot.get(slot_id)
        if q:
            self.size -= 1
            return q.popleft()
        if self.unaffine:
            self.size -= 1
            return self.unaffine.popleft()
        for s in neighbors:  # distance-ordered, slot_id first (already tried)
            q = self.per_slot.get(s.sid)
            if q:
                self.size -= 1
                return q.popleft()
        return None

    def withdraw(self, task: Task) -> bool:
        """Remove one specific queued task (migration support)."""
        q = self.per_slot.get(task.last_slot)
        if q is not None:
            try:
                q.remove(task)
            except ValueError:
                pass
            else:
                self.size -= 1
                return True
        try:
            self.unaffine.remove(task)
        except ValueError:
            return False
        self.size -= 1
        return True


class SchedCoop(Policy):
    name = "SCHED_COOP"
    preemptive = False

    def __init__(self, *, quantum: float = DEFAULT_QUANTUM):
        super().__init__()
        self.default_quantum = quantum
        self._jobs: "OrderedDict[int, _JobQueues]" = OrderedDict()
        self._current_jid: Optional[int] = None
        self._quantum_used: float = 0.0
        # registration-ordered job list + positions: the rotation order is
        # index arithmetic over this list, never rebuilt per pick
        self._jid_list: list[int] = []
        self._jid_pos: dict[int, int] = {}

    # -- job management -------------------------------------------------- #
    def on_job(self, job: Job) -> None:
        if job.jid not in self._jobs:
            self._jobs[job.jid] = _JobQueues(job)
            self._jid_pos[job.jid] = len(self._jid_list)
            self._jid_list.append(job.jid)
            if self._current_jid is None:
                self._current_jid = job.jid

    def on_job_detach(self, job: Job) -> None:
        jq = self._jobs.pop(job.jid, None)
        if jq is None:
            return
        if jq.size:  # arbiter withdraws queued work first; guard anyway
            self._jobs[job.jid] = jq
            left = [t.name for q in jq.per_slot.values() for t in q]
            left += [t.name for t in jq.unaffine]
            raise ValueError(
                f"detach of {job} with {jq.size} queued task(s) still in "
                f"this policy: {', '.join(left[:8])}"
            )
        self._jid_list.remove(job.jid)
        self._jid_pos = {jid: i for i, jid in enumerate(self._jid_list)}
        if self._current_jid == job.jid:
            self._current_jid = self._jid_list[0] if self._jid_list else None
            self._quantum_used = 0.0

    # -- queueing --------------------------------------------------------- #
    def on_ready(self, task: Task) -> None:
        self.on_job(task.job)
        self._jobs[task.job.jid].push(task)

    def remove(self, task: Task) -> None:
        jq = self._jobs.get(task.job.jid)
        if jq is None or not jq.withdraw(task):
            raise KeyError(f"{task} is not queued in {self.name}")

    def _job_quantum(self, jid: int) -> float:
        q = self._jobs[jid].job.quantum
        return q if q is not None else self.default_quantum

    def _rotate_if_expired(self) -> None:
        """Quantum evaluation — only ever called from scheduling points."""
        if self._current_jid is None:
            return
        if self._quantum_used >= self._job_quantum(self._current_jid):
            self._advance_current()

    def _advance_current(self) -> None:
        jids = self._jid_list
        if not jids:
            return
        i = self._jid_pos.get(self._current_jid, -1)
        n = len(jids)
        # next job with ready tasks; else keep rotating pointer anyway
        for off in range(1, n + 1):
            jid = jids[(i + off) % n]
            self._current_jid = jid
            self._quantum_used = 0.0
            if self._jobs[jid].size > 0:
                return

    # -- picking ----------------------------------------------------------- #
    def pick(self, slot_id: int) -> Optional[Task]:
        self._rotate_if_expired()
        assert self.sched is not None
        neighbors = self.sched.topology.neighbors_first(slot_id)
        jobs = self._jobs
        jids = self._jid_list
        n = len(jids)
        # rotation order: current job first, then registration order wrapped
        start = self._jid_pos.get(self._current_jid, 0)
        for off in range(n):
            jq = jobs[jids[(start + off) % n]]
            if jq.size:  # empty jobs can't serve: skip the placement search
                task = jq.pop_for(slot_id, neighbors)
                if task is not None:
                    return task
        return None

    def pick_filtered(self, slot_id: int, allowed_jids) -> Optional[Task]:
        """``pick`` restricted to member jobs in ``allowed_jids`` (per-job
        lease enforcement inside a shared group); same rotation order."""
        self._rotate_if_expired()
        assert self.sched is not None
        neighbors = self.sched.topology.neighbors_first(slot_id)
        jobs = self._jobs
        jids = self._jid_list
        n = len(jids)
        start = self._jid_pos.get(self._current_jid, 0)
        for off in range(n):
            jid = jids[(start + off) % n]
            if jid not in allowed_jids:
                continue
            jq = jobs[jid]
            if jq.size:
                task = jq.pop_for(slot_id, neighbors)
                if task is not None:
                    return task
        return None

    # -- accounting --------------------------------------------------------- #
    def on_stop(
        self, task: Task, slot_id: int, now: float, elapsed: float, reason: StopReason
    ) -> None:
        if task.job.jid == self._current_jid:
            self._quantum_used += elapsed

    # -- introspection ------------------------------------------------------- #
    def ready_count(self) -> int:
        return sum(j.size for j in self._jobs.values())

    def ready_count_of(self, job: Job) -> int:
        jq = self._jobs.get(job.jid)
        return jq.size if jq is not None else 0
