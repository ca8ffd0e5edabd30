"""Share of a training cell's traced interval in which the card is idle
while the trainer running on the slot is inside ``train.dispatch``: idle
because the host launches too slowly. Each idle piece of the device trace,
on the scheduler's clock, goes to the innermost span the running task had
open (``usfbench/spantrace.py``). Needs the program's spans, the
scheduler's decision records and a trace that read its clock pairs;
without them, nothing."""

from usfbench.spantrace import DISPATCH_SPANS, idle_by_label


def read(ctx):
    spans = getattr(ctx, "spans", None)
    records = getattr(ctx, "records", None)
    trace = ctx.trace
    if (trace is None or not spans or records is None or not ctx.jobs_of("train")
            or not getattr(trace, "pairs", None)):
        return None
    idle = idle_by_label(trace, spans, records)
    inside = sum(s for (_, name), s in idle.items() if name in DISPATCH_SPANS)
    return 100.0 * inside / trace.window_s
