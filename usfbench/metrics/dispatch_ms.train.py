"""Milliseconds of host time that launching one train step takes: the
median ``train.dispatch`` span (the step function's call, until it
returns) of the trainers' steps that ended in the window. Read from the
program's spans (``repro_torch.runtime.spans``), which the run arms when
it traces; without them, nothing."""

from usfbench.spantrace import median_ms


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if not spans or not ctx.jobs_of("train"):
        return None
    return median_ms(spans, "train.dispatch", ctx.t_w0, ctx.t_w1)
