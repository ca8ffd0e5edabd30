"""Share of the window the trainers' tasks spent READY, queued for a slot
of the USF runtime (``TaskStats.wait_time`` differenced over the
window)."""


def read(ctx):
    jobs = ctx.jobs_of("train")
    if not jobs:
        return None
    wait = sum(ctx.edge_delta(j, "wait") for j in jobs)
    return 100.0 * wait / (len(jobs) * ctx.window_s)
