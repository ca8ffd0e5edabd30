"""Milliseconds an engine step waits for the card in an open-loop cell:
the median ``engine.sync`` span (the copy of the step's argmax tokens to
the host, which waits behind every kernel queued before it on the stream)
of the steps that ended in the window. Read from the program's spans;
without them, nothing."""

from usfbench.spantrace import median_ms


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if not spans or not ctx.jobs_of("serve") or ctx.traffic.loop != "open":
        return None
    return median_ms(spans, "engine.sync", ctx.t_w0, ctx.t_w1)
