"""Share of a training cell's traced interval (where the cell file puts
it: within the window, or after it under the same load) in which no
kernel, copy or set ran on the card. The profiler's own cost a launch is
in it."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs_of("train"):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
