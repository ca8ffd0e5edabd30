"""Milliseconds in which the slot passes between steps and no trainer
launches work: the median, over the ``train.sync`` spans that ended in the
window, of the time from that sync's end to the next ``train.dispatch``
start of either trainer (the yield, the peer's loader wait and its copy to
the device). Read from the program's spans; without them, nothing."""

import statistics

from usfbench.spantrace import turnarounds


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if not spans or not ctx.jobs_of("train"):
        return None
    got = turnarounds(spans, ctx.t_w0, ctx.t_w1)
    return 1e3 * statistics.median(got) if got else None
