"""Share of the window the servers' worker tasks spent READY, queued for
a slot of the USF runtime (``TaskStats.wait_time`` differenced over the
window), in an open-loop cell."""


def read(ctx):
    jobs = ctx.jobs_of("serve")
    if not jobs or ctx.traffic.loop != "open":
        return None
    wait = sum(ctx.edge_delta(j, "wait") for j in jobs)
    return 100.0 * wait / (len(jobs) * ctx.window_s)
