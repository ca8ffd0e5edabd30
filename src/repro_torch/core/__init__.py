"""USF core: the paper's contribution.

A centralized, multi-job, user-space scheduling framework:

* ``Topology``/``Slot``   — execution resources (cores on the paper's node;
  device partitions on a TPU pod) grouped into locality domains (NUMA on the
  paper's node; ICI neighborhoods on a pod).
* ``Task``/``Job``        — schedulable work units owned by jobs (processes).
* ``Scheduler``           — the central scheduler: one running task per slot,
  worker swaps at blocking points only, pluggable policy.
* ``SlotArbiter``/``SlotLease`` — the job level of the two-level design:
  nice-weighted proportional slot leases with work-conserving borrowing,
  elastic resize, and attach/detach of jobs running *different* intra-job
  policies side by side (SCHED_COOP co-located with SCHED_FAIR).
* ``lease`` (``LeaseTable``)  — the extracted lease/quota machinery
  (largest-remainder apportionment + the I5 borrow order) shared by the
  arbiter and the cross-process ``repro_torch.ipc.NodeBroker``.
* ``policies``            — SCHED_COOP (the paper's default), SCHED_FAIR
  (EEVDF-like preemptive stand-in for Linux), SCHED_RR.
* ``sync``                — cooperative synchronization primitives with
  per-object FIFO wait queues (paper Listing 1), including the busy-wait
  barrier + yield adaptation of §5.2.
* ``events``              — discrete-event executor (virtual time) used to run
  the paper's experiments at pod scale deterministically.
* ``threads``             — real-thread executor ("glibcv" analogue): gates
  genuine Python threads (which dispatch genuine JAX work), preserves TLS,
  caches threads across create/join cycles (§4.3.1).
* ``autockpt``            — auto-checkpoint instrumentation: wrap jitted
  step functions (``preemptible``/``wrap_jit``) or hot loops
  (``maybe_checkpoint``) so every dispatch boundary is a preemption
  point, with a ``SimExecutor`` twin (``preemptible_body``) injecting
  the sim's checkpoint op at the same boundaries. The four preemption
  delivery tiers are documented in docs/PREEMPTION.md.
"""

from repro_torch.core.task import Task, Job, TaskState
from repro_torch.core.autockpt import (maybe_checkpoint, preemptible,
                                 preemptible_body, wrap_jit)
from repro_torch.core.topology import Topology, Slot
from repro_torch.core.arbiter import ArbiterError, SlotArbiter, SlotLease
from repro_torch.core.lease import LeaseTable, apportion, borrow_order
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.policies import SchedCoop, SchedFair, SchedRR, Policy
from repro_torch.core import sync
from repro_torch.core.stats import SchedStats

__all__ = [
    "Task",
    "Job",
    "TaskState",
    "Topology",
    "Slot",
    "Scheduler",
    "SlotArbiter",
    "SlotLease",
    "ArbiterError",
    "LeaseTable",
    "apportion",
    "borrow_order",
    "Policy",
    "SchedCoop",
    "SchedFair",
    "SchedRR",
    "sync",
    "SchedStats",
    "preemptible",
    "wrap_jit",
    "maybe_checkpoint",
    "preemptible_body",
]
