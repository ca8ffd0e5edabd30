"""75th percentile of request latency over every request due in the
window, each timed from when it was due to the join of its fan-out: the
highest percentile with ten or more of a window's ~41 requests beyond
it. A request still unanswered when the drain ends counts with the time
it had waited by then (a lower bound; it also fails the run's check)."""

from usfbench.generator import percentile


def read(ctx):
    due = ctx.traffic.due_in(ctx.t_w0, ctx.t_w1)
    if not due:
        return None
    return percentile([s.latency if s.latency is not None else ctx.t_drained - s.due
                       for s in due], 75)
