"""SCHED_RR — round-robin preemptive baseline (paper §3 comparison point).

A single global FIFO; running tasks are preempted when their quantum expires
and requeued at the tail. Unlike the real SCHED_RR class it has no priority
bands — the paper only uses it as a conceptual reference ("SCHED_COOP
resembles SCHED_RR, where threads run until they yield or block", except
SCHED_RR still time-slices among same-priority peers).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.task import Task


class SchedRR(Policy):
    name = "SCHED_RR"
    preemptive = True

    def __init__(self, *, quantum: float = 0.010):
        super().__init__()
        self.quantum = quantum
        self.tick_interval = quantum
        self._q: Deque[Task] = deque()
        self._run_started: dict[int, float] = {}
        self._per_job: dict[int, int] = {}

    def on_job_detach(self, job) -> None:
        # queues hold none of the job's tasks by contract (quiescent, or
        # withdrawn via remove() on a live re-home); drop the slice-start
        # stamps so a default-group SchedRR does not leak them across
        # swap churn
        for t in job.tasks:
            self._run_started.pop(t.tid, None)

    def on_ready(self, task: Task) -> None:
        self._q.append(task)
        jid = task.job.jid
        self._per_job[jid] = self._per_job.get(jid, 0) + 1

    def _drop_count(self, task: Task) -> None:
        jid = task.job.jid
        left = self._per_job[jid] - 1
        if left:
            self._per_job[jid] = left
        else:
            del self._per_job[jid]

    def pick(self, slot_id: int) -> Optional[Task]:
        if not self._q:
            return None
        task = self._q.popleft()
        self._drop_count(task)
        return task

    def pick_filtered(self, slot_id: int, allowed_jids) -> Optional[Task]:
        """First-in-FIFO task of an allowed job (O(n) scan: the filtered
        path only runs under per-job lease enforcement)."""
        for task in self._q:
            if task.job.jid in allowed_jids:
                self._q.remove(task)
                self._drop_count(task)
                return task
        return None

    def remove(self, task: Task) -> None:
        try:
            self._q.remove(task)
        except ValueError:
            raise KeyError(f"{task} is not queued in {self.name}") from None
        self._drop_count(task)

    def on_run(self, task: Task, slot_id: int, now: float) -> None:
        self._run_started[task.tid] = now

    def should_preempt(self, task: Task, slot_id: int, now: float) -> bool:
        if not self._q:
            return False
        return (now - self._run_started.get(task.tid, now)) >= self.quantum

    def ready_count(self) -> int:
        return len(self._q)

    def ready_count_of(self, job) -> int:
        return self._per_job.get(job.jid, 0)
