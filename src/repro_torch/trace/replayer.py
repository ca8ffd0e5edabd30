"""Trace replay: feed recorded or synthesized workloads through
``SimExecutor`` at hundreds-of-thousands of events per second.

Three layers:

* ``Workload`` — the replayable model: jobs, tasks (arrival time, ids,
  deadline, op list), control events (attach/demote/detach/resize/width).
* ``reconstruct`` — decision stream → Workload. Intrinsic ops (compute/
  stall/sleep/yield/checkpoint) are recorded verbatim; each *sync* block
  (lock/semaphore/barrier/cv/join/channel) appears in the stream as a
  BLOCK record not explained by a sleep op and is re-encoded as an
  absolute-time ``sleep_until`` at its recorded WAKE timestamp — replaying
  the *observed* blocking behaviour without the live sync objects.
* ``Replayer`` — builds a fresh executor and streams the workload through
  it: bodies are C-level tuple iterators over pre-decoded op tuples (no
  per-event allocation, no generator frames), job ids are pre-interned to
  ``Job`` objects, identical op lists are shared, and arrivals feed the
  heap one event at a time (``SimExecutor.feed``), keeping every heap pop
  shallow at million-task scale.

Determinism: the same workload under the same config is bit-identical —
``run(record=True)`` re-records the replay so ``decision_stream`` diffs
prove it (tids/jids are normalized back into trace id space first, since
live id counters are process-global).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Iterable, Optional

from repro_torch.core.deadline import DeadlineArbiter
from repro_torch.core.events import SimExecutor
from repro_torch.core.scheduler import (
    REC_ATTACH,
    REC_BLOCK,
    REC_DEMOTE,
    REC_DETACH,
    REC_DISPATCH,
    REC_DONE,
    REC_JOB,
    REC_OP,
    REC_PREEMPT,
    REC_RESIZE,
    REC_SPAWN,
    REC_TARGET,
    REC_URGENT,
    REC_WAKE,
    REC_YIELD,
)
from repro_torch.core.simtask import SimCosts
from repro_torch.core.stats import SchedStats
from repro_torch.core.task import Job, Task
from repro_torch.core.topology import Topology
from repro_torch.trace import schema
from repro_torch.trace.recorder import TraceRecorder

#: codes whose (time, payload) sequence must be bit-identical between a
#: recording and its replay under the same config. OP is excluded: sync
#: ops are re-encoded as sleep_until on replay (documented approximation);
#: DL_POST/REQUEST are external-input records, re-derived only partially.
DECISION_CODES = frozenset((
    REC_SPAWN, REC_DISPATCH, REC_BLOCK, REC_YIELD, REC_DONE,
    REC_PREEMPT, REC_WAKE, REC_TARGET, REC_URGENT,
))

_SLEEP_OPS = ("sleep", "sleep_until")


@dataclasses.dataclass
class JobSpec:
    jid: int
    name: str = ""
    nice: int = 0
    share: Optional[float] = None
    policy: Optional[tuple] = None  # (name, param) or None = default group


@dataclasses.dataclass
class TaskSpec:
    t: float
    tid: int
    jid: int
    deadline: Optional[float]
    cost_hint: Optional[float]
    ops: tuple


@dataclasses.dataclass
class Workload:
    jobs: list
    tasks: list                              # sorted by arrival time
    control: list = dataclasses.field(default_factory=list)
    #                                        # (t, kind, jid_or_n, arg)
    meta: dict = dataclasses.field(default_factory=dict)

    def n_ops(self) -> int:
        return sum(len(t.ops) for t in self.tasks)

    # ------------------------------------------------------------------ #
    # (de)serialization — schema v1 "workload" kind
    # ------------------------------------------------------------------ #
    def to_lines(self) -> Iterable[list]:
        for j in self.jobs:
            yield ["J", j.jid, j.name, j.nice, j.share,
                   None if j.policy is None else list(j.policy)]
        for (t, kind, a, b) in self.control:
            yield ["C", t, kind, a, b]
        for ts in self.tasks:
            yield ["T", ts.t, ts.tid, ts.jid, ts.deadline, ts.cost_hint,
                   [schema.encode_op(op) for op in ts.ops]]

    def save(self, path: str) -> int:
        return schema.save_trace(path, schema.KIND_WORKLOAD,
                                 self.to_lines(), self.meta)

    @classmethod
    def from_lines(cls, lines: Iterable[list],
                   meta: Optional[dict] = None) -> "Workload":
        jobs, tasks, control = [], [], []
        for arr in lines:
            tag = arr[0]
            if tag == "T":
                _, t, tid, jid, dl, ch, ops = arr
                tasks.append(TaskSpec(t, tid, jid, dl, ch,
                                      tuple(schema.decode_op(o) for o in ops)))
            elif tag == "J":
                _, jid, name, nice, share, pol = arr
                jobs.append(JobSpec(jid, name, nice, share,
                                    None if pol is None else tuple(pol)))
            elif tag == "C":
                _, t, kind, a, b = arr
                control.append((t, kind, a,
                                tuple(b) if isinstance(b, list) else b))
            else:
                raise schema.TraceSchemaError(f"unknown workload tag {tag!r}")
        tasks.sort(key=lambda ts: ts.t)
        return cls(jobs=jobs, tasks=tasks, control=control,
                   meta=dict(meta or {}))

    @classmethod
    def load(cls, path: str) -> "Workload":
        header, lines = schema.iter_trace(path)
        if header["kind"] != schema.KIND_WORKLOAD:
            raise schema.TraceSchemaError(
                f"expected a workload trace, got {header['kind']!r}"
            )
        return cls.from_lines(lines, header.get("meta"))


# --------------------------------------------------------------------- #
# decision stream -> workload
# --------------------------------------------------------------------- #
def reconstruct(records: Iterable[tuple],
                meta: Optional[dict] = None) -> Workload:
    """Rebuild a replayable ``Workload`` from a recorded decision stream
    (op recording must have been armed — ``TraceRecorder.attach_sim``).

    Sync blocks become ``sleep_until`` at the recorded wake time; a block
    whose wake never came (run truncated) is dropped — the replayed task
    completes its recorded prefix. Dynamic spawns appear as top-level
    tasks at their recorded submit times.
    """
    jobs: dict[int, JobSpec] = {}
    tasks: dict[int, TaskSpec] = {}
    ops: dict[int, list] = {}
    #: per task: FIFO of outstanding blocks — True if owned by a sleep op
    pending_block: dict[int, list] = {}
    #: per task: index of the trailing sleep op already credited with a
    #: block — a sleep explains at most ONE block, so a sync block that
    #: lands right after a completed sleep (or after a re-encoded
    #: sleep_until) must not be attributed to it and silently dropped
    claimed: dict[int, int] = {}
    control: list = []

    for (t, code, a, b) in records:
        if code == REC_OP:
            lst = ops.get(a)
            if lst is not None:
                lst.append(b)
        elif code == REC_SPAWN:
            jid, deadline, cost_hint = b
            tasks[a] = TaskSpec(t, a, jid, deadline, cost_hint, ())
            ops[a] = []
            pending_block[a] = []
            if jid not in jobs:
                jobs[jid] = JobSpec(jid)
        elif code == REC_BLOCK:
            pb = pending_block.get(a)
            if pb is None:
                continue
            lst = ops[a]
            idx = len(lst) - 1
            owned_by_sleep = bool(lst) and lst[-1][0] in _SLEEP_OPS \
                and not pb and claimed.get(a) != idx
            if owned_by_sleep:
                claimed[a] = idx
            pb.append(owned_by_sleep)
        elif code == REC_WAKE:
            pb = pending_block.get(a)
            if not pb:
                continue
            if not pb.pop(0):
                # sync block: replay it as an absolute-time sleep ending
                # at this recorded wake (synthetic — it must not claim the
                # task's next block, its own already happened)
                lst = ops[a]
                lst.append(("sleep_until", t))
                claimed[a] = len(lst) - 1
        elif code == REC_JOB:
            name, nice, share = b
            spec = jobs.get(a)
            if spec is None:
                jobs[a] = JobSpec(a, name, nice, share)
            else:
                spec.name, spec.nice, spec.share = name, nice, share
        elif code == REC_ATTACH:
            share, pol = b
            jobs.setdefault(a, JobSpec(a))
            control.append((t, "attach", a, (share,
                                             None if pol is None
                                             else tuple(pol))))
        elif code == REC_DEMOTE:
            control.append((t, "demote", a, b))
        elif code == REC_DETACH:
            control.append((t, "detach", a, None))
        elif code == REC_RESIZE:
            control.append((t, "resize", a, b))
        elif code == REC_TARGET:
            control.append((t, "target", a, None))
        # DISPATCH/YIELD/DONE/PREEMPT/URGENT/DL_*/REQUEST*: decisions and
        # engine-level records — re-derived by the replay, not replayed.

    # attaches at-or-before the first arrival are initial configuration:
    # fold them into the JobSpec (the replayer attaches those eagerly).
    # Later attaches are live re-homes and stay control events — the job
    # must start in whatever group it had when the recording began.
    t0 = min((ts.t for ts in tasks.values()), default=0.0)
    kept = []
    for c in control:
        if c[1] == "attach" and c[0] <= t0:
            spec = jobs[c[2]]
            spec.share, spec.policy = c[3]
        else:
            kept.append(c)
    control = kept

    out = []
    for tid, spec in tasks.items():
        spec.ops = tuple(ops[tid])
        out.append(spec)
    out.sort(key=lambda ts: ts.t)
    return Workload(jobs=sorted(jobs.values(), key=lambda j: j.jid),
                    tasks=out, control=sorted(control, key=lambda c: c[0]),
                    meta=dict(meta or {}))


# --------------------------------------------------------------------- #
# replay
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ReplayConfig:
    """Executor/policy configuration for one replay run (the A/B axis)."""
    slots: int = 8
    domains: int = 2
    default_policy: tuple = ("SCHED_COOP", None)
    #: "none" (share-based SlotArbiter) or "deadline" (EDF/least-laxity)
    arbiter: str = "none"
    #: jid -> (name, param) overrides on top of the workload's own attaches
    policies: dict = dataclasses.field(default_factory=dict)
    costs: Optional[SimCosts] = None
    max_time: float = 1e9
    max_events: int = 200_000_000

    def build_sim(self) -> SimExecutor:
        pol = schema.build_policy(self.default_policy)
        arb = None
        if self.arbiter == "deadline":
            arb = DeadlineArbiter(pol)
        elif self.arbiter != "none":
            raise ValueError(f"unknown arbiter {self.arbiter!r}")
        return SimExecutor(
            Topology(self.slots, self.domains),
            pol, costs=self.costs, max_time=self.max_time,
            max_events=self.max_events, arbiter=arb,
        )


@dataclasses.dataclass
class ReplayResult:
    stats: SchedStats
    events: int
    wall_s: float
    tasks: list                    # replayed Task objects (trace order)
    tid_of: dict                   # new tid -> trace tid
    jid_of: dict                   # new jid -> trace jid
    recorder: Optional[TraceRecorder]
    sim: SimExecutor

    @property
    def events_per_sec(self) -> float:
        return self.events / self.wall_s if self.wall_s > 0 else 0.0

    def normalized_records(self) -> list:
        """Re-recorded stream with tids/jids mapped into trace id space
        (for diffing against the source recording)."""
        if self.recorder is None:
            raise ValueError("replay ran without record=True")
        return normalize_stream(self.recorder.records(),
                                self.tid_of, self.jid_of)


class Replayer:
    """One replayable workload bound to one config; ``run()`` executes."""

    def __init__(self, workload: Workload,
                 config: Optional[ReplayConfig] = None):
        self.workload = workload
        self.config = config or ReplayConfig()

    def run(self, *, record: bool = False, until: Optional[float] = None,
            recorder: Optional[TraceRecorder] = None) -> ReplayResult:
        wl = self.workload
        cfg = self.config
        sim = cfg.build_sim()

        # arm before the eager attaches below: they happen at sim time 0,
        # and a re-recording must capture them so reconstructing the
        # replay folds them back into the JobSpecs (fixed point)
        rec = recorder
        if record and rec is None:
            rec = TraceRecorder()
        if rec is not None:
            rec.attach_sim(sim, ops=True)

        # pre-intern jobs (trace jid -> live Job) and attach leases
        jid_of: dict[int, int] = {}
        job_of: dict[int, Job] = {}
        for spec in wl.jobs:
            job = Job(spec.name or f"job{spec.jid}", nice=spec.nice,
                      share=spec.share)
            job_of[spec.jid] = job
            jid_of[job.jid] = spec.jid
            pol = cfg.policies.get(spec.jid, spec.policy)
            if pol is not None:
                # dedicated group; default-group jobs register lazily on
                # first submit (their share rides on the Job itself), the
                # same path the recorded run took
                sim.attach(job, policy=schema.build_policy(pol),
                           share=spec.share)

        # batch-decode tasks: shared op tuples -> C-level tuple-iterator
        # bodies, one Task per spec, arrivals streamed (not pre-posted)
        interned: dict = {}
        tasks = []
        tid_of: dict[int, int] = {}
        for ts in wl.tasks:
            body = interned.get(ts.ops)
            if body is None:
                body = interned[ts.ops] = functools.partial(iter, ts.ops)
            task = Task(job_of[ts.jid], body=body, deadline=ts.deadline,
                        cost_hint=ts.cost_hint or 0.0)
            tid_of[task.tid] = ts.tid
            tasks.append(task)

        for (t, kind, a, b) in wl.control:
            self._post_control(sim, job_of, t, kind, a, b)

        arrivals = iter([(ts.t, task)
                         for ts, task in zip(wl.tasks, tasks)])
        sim.feed(arrivals)
        t0 = time.perf_counter()
        stats = sim.run(until=until)
        wall = time.perf_counter() - t0
        if rec is not None:
            rec.detach_all()
        return ReplayResult(stats=stats, events=sim.events_processed,
                            wall_s=wall, tasks=tasks, tid_of=tid_of,
                            jid_of=jid_of, recorder=rec, sim=sim)

    @staticmethod
    def _post_control(sim: SimExecutor, job_of: dict, t: float,
                      kind: str, a, b) -> None:
        if kind == "attach":
            share, pol = b
            sim._post(t, lambda: sim.attach(
                job_of[a], policy=schema.build_policy(pol), share=share))
        elif kind == "demote":
            sim._post(t, lambda: sim.demote(job_of[a], share=b))
        elif kind == "detach":
            sim._post(t, lambda: sim.detach(job_of[a]))
        elif kind == "resize":
            sim._post(t, lambda: job_of[a].lease.resize(b))
        elif kind == "target":
            sim._post(t, lambda: sim.set_slot_target(a))
        else:
            raise schema.TraceSchemaError(f"unknown control {kind!r}")


# --------------------------------------------------------------------- #
# determinism diffing
# --------------------------------------------------------------------- #
def normalize_stream(records: Iterable[tuple], tid_of: dict,
                     jid_of: dict) -> list:
    """Map a re-recorded stream's process-global tids/jids back into the
    id space of the source trace so streams are directly comparable."""
    out = []
    for (t, code, a, b) in records:
        if code in (REC_OP, REC_DISPATCH, REC_BLOCK, REC_YIELD, REC_DONE,
                    REC_PREEMPT, REC_WAKE):
            a = tid_of.get(a, a)
        elif code == REC_SPAWN:
            a = tid_of.get(a, a)
            b = (jid_of.get(b[0], b[0]),) + tuple(b[1:])
        elif code in (REC_JOB, REC_ATTACH, REC_DEMOTE, REC_DETACH,
                      REC_RESIZE):
            a = jid_of.get(a, a)
        elif code == REC_URGENT:
            if b is not None:
                b = tid_of.get(b, b)
        out.append((t, code, a, b))
    return out


def decision_stream(records: Iterable[tuple]) -> list:
    """The bit-identity subset: scheduling decisions only."""
    return [r for r in records if r[1] in DECISION_CODES]


def diff_streams(a: Iterable[tuple], b: Iterable[tuple]) -> Optional[dict]:
    """First divergence between two decision streams (None = identical).
    Compares the DECISION_CODES subset, payloads and timestamps bit-for-
    bit (floats must round-trip exactly — they do through both memory
    and the JSONL encoding)."""
    da, db = decision_stream(a), decision_stream(b)
    for i, (ra, rb) in enumerate(zip(da, db)):
        if ra != rb:
            return {"index": i, "a": ra, "b": rb}
    if len(da) != len(db):
        n = min(len(da), len(db))
        return {"index": n,
                "a": da[n] if len(da) > n else None,
                "b": db[n] if len(db) > n else None}
    return None
