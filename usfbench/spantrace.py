"""The program's spans joined to the device trace: the trace's events on
the scheduler's clock, each idle piece of the traced interval put down to
the span that the task running on the slot had open, and the span readings
the per-layer metrics take.

Inputs, besides the trace: the spans of ``repro_torch.runtime.spans``
(``(t0, t1, name, tid, key, attr)``, ``key[0]`` the job's name) and the
decision records of an armed ``TraceRecorder`` (``(t, code, tid, slot)``
for a dispatch and a stop), both on ``time.monotonic``.

Kineto gives device events in Unix-epoch nanoseconds, so ``ClockedTrace``
reads a pair of the two clocks at the profiler's start and at its stop and
converts each event with the offset interpolated between them."""

from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict

from repro_torch.core.scheduler import (REC_BLOCK, REC_DISPATCH, REC_DONE, REC_PREEMPT,
                                        REC_YIELD)
from usfbench.trace import DeviceTrace

NO_TASK, NO_SPAN = "no task", "no span"
#: a gap mostly outside the traced interval (kernels the profiler records
#: while it starts or stops): no decision record or span is read there
OUTSIDE = "outside the trace"
#: the records that end a task's stretch on a slot
STOPS = (REC_BLOCK, REC_YIELD, REC_DONE, REC_PREEMPT)
#: the spans inside a train step's dispatch: train.dispatch and its children
DISPATCH_SPANS = ("train.dispatch", "train.fwd_bwd", "train.optimizer")


def clock_pair(reads: int = 5) -> tuple[int, int]:
    """``(monotonic ns, Unix ns)`` at one instant: of ``reads`` Unix reads,
    each between two monotonic reads, the one whose bracket is tightest,
    against its bracket's middle."""
    best = None
    for _ in range(reads):
        a = time.monotonic_ns()
        u = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


class ClockedTrace(DeviceTrace):
    """A ``DeviceTrace`` that reads a clock pair just before its profiler
    starts and again once it has stopped."""

    def __init__(self, start: float, stop: float):
        super().__init__(start, stop)
        self.pairs: list[tuple[int, int]] = []

    def _main(self) -> None:
        time.sleep(max(0.0, self.start_at - time.monotonic()))
        self.pairs.append(clock_pair())
        super()._main()
        self.pairs.append(clock_pair())

    def offsets_ns(self) -> list[int]:
        """Unix minus monotonic nanoseconds at each pair."""
        return [u - m for m, u in self.pairs]

    def to_monotonic(self, unix_ns: int) -> float:
        """A Unix-epoch time as ``time.monotonic`` seconds: the offset
        interpolated between the two pairs by Unix time."""
        (m0, u0), (m1, u1) = self.pairs[0], self.pairs[-1]
        o0, o1 = u0 - m0, u1 - m1
        off = o0 if u1 == u0 else o0 + round((o1 - o0) * (unix_ns - u0) / (u1 - u0))
        return (unix_ns - off) / 1e9

    def busy(self) -> list[tuple[float, float, str]]:
        """The merged busy intervals on the monotonic clock, with the name
        of the last kernel in each."""
        return [(self.to_monotonic(a), self.to_monotonic(b), name)
                for a, b, name in self._merged()]


def running_changes(records: list) -> list[tuple[float, dict]]:
    """``(t, {slot: tid})`` after each dispatch or stop, in the stream's
    order (a record's time never runs back before the last one's)."""
    running: dict = {}
    out = []
    last = float("-inf")
    for t, code, tid, slot in records:
        if code == REC_DISPATCH:
            running[slot] = tid
        elif code in STOPS and running.get(slot) == tid:
            del running[slot]
        else:
            continue
        last = max(last, t)
        out.append((last, dict(running)))
    return out


def owners(spans: list, records: list, t0: float, t1: float) -> list[tuple]:
    """[t0, t1) cut where a task starts or stops running or a span opens or
    closes: ``(a, b, [(label, weight), ...])``. A label is ``(job, span
    name)`` of the innermost span open on a running task, ``(job,
    NO_SPAN)`` for a running task with none open, or ``(None, NO_TASK)``
    when no task runs; several running tasks share a piece equally."""
    job_of = {s[3]: s[4][0] for s in spans if s[3] is not None}
    events = []  # (t, order, tiebreak, item): ends, starts (parents first), runs
    for i, s in enumerate(spans):
        if s[3] is None or s[1] <= t0 or s[0] >= t1:
            continue
        events.append((s[0], 1, s[0] - s[1], i))
        events.append((s[1], 0, s[1] - s[0], i))
    for t, running in running_changes(records):
        events.append((t, 2, 0.0, running))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    stacks: dict = defaultdict(list)
    running: dict = {}

    def labels() -> list:
        tids = sorted(set(running.values()), key=str)
        if not tids:
            return [((None, NO_TASK), 1.0)]
        return [((job_of.get(tid), spans[stacks[tid][-1]][2] if stacks[tid] else NO_SPAN),
                 1.0 / len(tids)) for tid in tids]

    out = []
    at = t0
    for t, order, _, item in events:
        if t > at and at < t1:
            out.append((at, min(t, t1), labels()))
            at = min(t, t1)
        if order == 2:
            running = item
        elif order == 1:
            stacks[spans[item][3]].append(item)
        elif item in stacks[spans[item][3]]:
            stacks[spans[item][3]].remove(item)
    if at < t1:
        out.append((at, t1, labels()))
    return out


def idle_intervals(busy: list[tuple], t0: float, t1: float) -> list[tuple[float, float]]:
    """The complement of the busy intervals within [t0, t1)."""
    out = []
    at = t0
    for a, b, _ in busy:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def attribute(intervals: list[tuple[float, float]], pieces: list[tuple]) -> list[dict]:
    """For each interval (sorted, disjoint), the seconds each label of the
    ``owners`` pieces holds within it."""
    out = []
    j = 0
    for a, b in intervals:
        acc: dict = defaultdict(float)
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            pa, pb, labels = pieces[k]
            inside = min(b, pb) - max(a, pa)
            if inside > 0:
                for lab, w in labels:
                    acc[lab] += w * inside
            k += 1
        out.append(acc)
    return out


def label_name(label: tuple) -> str:
    job, name = label
    return name if job is None else f"{job}:{name}"


def idle_by_label(trace: ClockedTrace, spans: list, records: list) -> dict:
    """Idle seconds of the traced interval by ``(job, span name)``."""
    pieces = owners(spans, records, trace.t0, trace.t1)
    total: dict = defaultdict(float)
    for acc in attribute(idle_intervals(trace.busy(), trace.t0, trace.t1), pieces):
        for lab, s in acc.items():
            total[lab] += s
    return dict(total)


def longest_gaps(trace: ClockedTrace, spans: list, records: list, top: int = 10) -> list:
    """The ``top`` longest gaps between busy intervals, longest first, as
    ``DeviceTrace.breakdown`` picks them: ``(seconds, kernel before, {label:
    idle seconds within the gap})``."""
    merged = trace._merged()
    gaps = sorted(((merged[i][1], merged[i + 1][0], merged[i][2])
                   for i in range(len(merged) - 1)), key=lambda g: -(g[1] - g[0]))[:top]
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0])
    accs = attribute([(trace.to_monotonic(gaps[i][0]), trace.to_monotonic(gaps[i][1]))
                      for i in order], owners(spans, records, trace.t0, trace.t1))
    held = dict(zip(order, accs))
    return [((b - a) / 1e9, name, dict(held[i])) for i, (a, b, name) in enumerate(gaps)]


def _holder(seconds: float, acc: dict) -> str:
    """The label that holds most of a gap, or OUTSIDE where more of it lies
    outside the traced interval than any label holds."""
    if not acc or seconds - sum(acc.values()) > max(acc.values()):
        return OUTSIDE
    return label_name(max(acc, key=acc.get))


def breakdown(trace: ClockedTrace, spans: list, records: list, top: int = 10) -> dict:
    """``DeviceTrace.breakdown()``; where there are spans, each idle gap's
    name prefixed with the job and span that hold most of it (``OUTSIDE``
    for a gap mostly outside the traced interval), and ``idle_by_span``:
    idle seconds by span name within the interval, the ``top`` largest."""
    out = trace.breakdown(top)
    if not spans:
        return out
    out["idle_gaps"] = [[f"{_holder(s, acc)} after {kernel[:150]}", s]
                        for s, kernel, acc in longest_gaps(trace, spans, records, top)]
    by_span: dict = defaultdict(float)
    for (_, name), s in idle_by_label(trace, spans, records).items():
        by_span[name] += s
    out["idle_by_span"] = [[k, v] for k, v in
                           sorted(by_span.items(), key=lambda x: -x[1])[:top]]
    return out


# ---------------------------------------------------------------------- #
# span readings
# ---------------------------------------------------------------------- #
def durations(spans: list, name: str, a: float, b: float) -> list[float]:
    """Seconds of each ``name`` span that ended in [a, b)."""
    return [s[1] - s[0] for s in spans if s[2] == name and a <= s[1] < b]


def median_ms(spans: list, name: str, a: float, b: float):
    got = durations(spans, name, a, b)
    return 1e3 * statistics.median(got) if got else None


def turnarounds(spans: list, a: float, b: float) -> list[float]:
    """For each ``train.sync`` that ended in [a, b), the seconds from its
    end to the next ``train.dispatch`` start of any trainer."""
    starts = sorted(s[0] for s in spans if s[2] == "train.dispatch")
    out = []
    for s in spans:
        if s[2] == "train.sync" and a <= s[1] < b:
            i = bisect.bisect_left(starts, s[1])
            if i < len(starts):
                out.append(starts[i] - s[1])
    return out


def coverage(spans: list, tid, names: tuple, a: float, b: float) -> float:
    """Share of [a, b) that ``tid``'s spans named in ``names`` cover."""
    ivs = sorted((max(s[0], a), min(s[1], b)) for s in spans
                 if s[3] == tid and s[2] in names and s[1] > a and s[0] < b)
    covered = 0.0
    at = a
    for x, y in ivs:
        if y > at:
            covered += y - max(x, at)
            at = y
    return covered / (b - a)
