"""Training tokens a second over the window, from every trainer of the
cell: each step counts by the share of its own interval that lies inside
the window."""

from usfbench.generator import overlap_rate


def read(ctx):
    steps = [iv for j in ctx.jobs_of("train") for iv in j.intervals]
    return overlap_rate(steps, ctx.t_w0, ctx.t_w1) if steps else None
