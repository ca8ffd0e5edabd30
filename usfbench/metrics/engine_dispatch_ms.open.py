"""Milliseconds of host time that launching one engine step takes in an
open-loop cell: the median ``engine.dispatch`` span (the token and
position copies and the decode step's call) of the steps that ended in the
window. Read from the program's spans; without them, nothing."""

from usfbench.spantrace import median_ms


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if not spans or not ctx.jobs_of("serve") or ctx.traffic.loop != "open":
        return None
    return median_ms(spans, "engine.dispatch", ctx.t_w0, ctx.t_w1)
