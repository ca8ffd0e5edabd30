"""Cluster-trace adapter: Google/Alibaba-style task-event tables →
replayable ``Workload``.

Both public cluster traces describe tasks as *event rows* — a SUBMIT when
the task enters the cluster, a SCHEDULE when it is placed, a FINISH (or
FAIL/KILL/EVICT) when it leaves — keyed by (job id, task index). This
adapter folds such rows into per-task records and emits one ``TaskSpec``
per task: arrival = submit time, duration = finish − schedule (chunked
into compute ops at a scheduling granularity), job grouping preserved.

The reader is column-name driven (``columns`` maps logical fields to CSV
header names or 0-based indices for headerless files, as Google's
distribution ships), so the same code ingests either trace format or any
CSV shaped like them::

    wl = load_task_events("task_events.csv",
                          columns={"time": 0, "jid": 2, "tid": 3,
                                   "event": 5},
                          time_scale=1e-6)       # Google: microseconds

Tasks whose duration is unknown (no terminal event in the window, or a
truncated file) get ``default_duration``. Times are shifted so the first
submit lands at t=0.
"""

from __future__ import annotations

import csv
from typing import Iterable, Optional, Union

from repro_torch.trace.replayer import JobSpec, TaskSpec, Workload

#: Google cluster-data v2 task_events column order (headerless CSV)
GOOGLE_COLUMNS = {"time": 0, "jid": 2, "tid": 3, "event": 5}
#: Alibaba cluster-trace-v2018 batch_task column order
ALIBABA_COLUMNS = {"tid": 0, "jid": 2, "event": 4,
                   "time": 5, "end_time": 6}

#: event-type spellings -> canonical phase
_SUBMIT = {"0", "submit", "waiting", "ready"}
_SCHEDULE = {"1", "schedule", "running"}
_FINISH = {"4", "finish", "finished", "terminated"}
_DEAD = {"2", "3", "5", "6", "evict", "fail", "failed", "kill",
         "killed", "lost", "cancelled"}


def _col(row, key):
    return row[key] if isinstance(key, int) else row.get(key)


def load_task_events(
    source: Union[str, Iterable],
    *,
    columns: Optional[dict] = None,
    time_scale: float = 1.0,
    chunk_s: float = 0.001,
    default_duration: float = 0.010,
    max_tasks: Optional[int] = None,
    has_header: Optional[bool] = None,
) -> Workload:
    """Fold a task-event CSV into a ``Workload``.

    Parameters
    ----------
    source:            path or an iterable of already-split rows.
    columns:           logical→physical column map; keys ``time``, ``jid``,
                       ``tid``, ``event`` required, ``end_time`` optional
                       (Alibaba-style one-row-per-task tables). Defaults to
                       ``GOOGLE_COLUMNS``.
    time_scale:        seconds per trace time unit (Google: 1e-6).
    chunk_s:           scheduling granularity a task's duration is chunked
                       into (each chunk is one compute op → one potential
                       scheduling point, like the serving benchmarks).
    default_duration:  seconds for tasks with no terminal event.
    max_tasks:         stop after this many distinct tasks (None = all).
    """
    cols = dict(GOOGLE_COLUMNS if columns is None else columns)
    for k in ("time", "jid", "tid", "event"):
        if k not in cols:
            raise ValueError(f"columns must map {k!r}")
    by_index = any(isinstance(v, int) for v in cols.values())

    if isinstance(source, str):
        fh = open(source, newline="")
        rows: Iterable = csv.reader(fh)
    else:
        fh = None
        rows = iter(source)

    # (jid, tid) -> [submit_t, schedule_t, end_t, dead]
    tasks: dict[tuple, list] = {}
    order: list[tuple] = []
    try:
        first = next(iter(rows), None)
        if first is None:
            raise ValueError("empty task-event table")
        header_row = None
        if has_header or (has_header is None and not by_index and
                          not isinstance(first, dict)):
            header_row = [str(c).strip() for c in first]
        rowiter = rows if header_row is not None else _chain_first(first,
                                                                   rows)
        for raw in rowiter:
            if header_row is not None and not isinstance(raw, dict):
                raw = dict(zip(header_row, raw))
            try:
                t = float(_col(raw, cols["time"])) * time_scale
                jid = str(_col(raw, cols["jid"]))
                tid = str(_col(raw, cols["tid"]))
                ev = str(_col(raw, cols["event"])).strip().lower()
            except (TypeError, ValueError, IndexError, KeyError):
                continue  # malformed row — cluster dumps have them
            key = (jid, tid)
            rec = tasks.get(key)
            if rec is None:
                if max_tasks is not None and len(tasks) >= max_tasks:
                    continue
                rec = tasks[key] = [None, None, None, False]
                order.append(key)
            if ev in _SUBMIT:
                if rec[0] is None:
                    rec[0] = t
            elif ev in _SCHEDULE:
                if rec[1] is None:
                    rec[1] = t
            elif ev in _FINISH:
                rec[2] = t
            elif ev in _DEAD:
                rec[3] = True
            end_key = cols.get("end_time")
            if end_key is not None:
                # one-row-per-task tables (Alibaba style): `time` is the
                # task's start regardless of the row's status spelling —
                # a lone "terminated" row must still yield a start time
                if rec[0] is None:
                    rec[0] = t
                try:
                    rec[2] = float(_col(raw, end_key)) * time_scale
                except (TypeError, ValueError, IndexError, KeyError):
                    pass
    finally:
        if fh is not None:
            fh.close()

    if not tasks:
        raise ValueError("no usable task events in table")

    starts = [r[0] if r[0] is not None else r[1] for r in tasks.values()]
    starts = [s for s in starts if s is not None]
    t0 = min(starts) if starts else 0.0
    jobs: dict[str, JobSpec] = {}
    specs = []
    defaulted = 0
    for i, key in enumerate(order):
        jid_s, _ = key
        submit, sched, end, dead = tasks[key]
        if dead and end is None:
            continue  # killed before running: nothing to replay
        arr = (submit if submit is not None else sched or t0) - t0
        started = sched if sched is not None else submit
        if end is not None and started is not None and end > started:
            dur = (end - started)
        else:
            dur = default_duration
            defaulted += 1
        job = jobs.get(jid_s)
        if job is None:
            job = jobs[jid_s] = JobSpec(len(jobs), f"job:{jid_s}")
        n = max(1, round(dur / chunk_s))
        ops = tuple([("compute", dur / n, 0.0)] * n)
        specs.append(TaskSpec(arr, i, job.jid, None, dur, ops))

    specs.sort(key=lambda ts: ts.t)
    return Workload(
        jobs=sorted(jobs.values(), key=lambda j: j.jid),
        tasks=specs,
        meta={"generator": "task_events", "time_scale": time_scale,
              "chunk_s": chunk_s, "n_tasks": len(specs),
              "n_jobs": len(jobs), "defaulted_durations": defaulted},
    )


def _chain_first(first, rest):
    yield first
    yield from rest
