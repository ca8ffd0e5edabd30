"""Milliseconds an engine step of a server takes in the window of an
open-loop cell: the window over the mean count of steps the servers took
(``InferenceServer.steps`` read at both edges)."""


def read(ctx):
    servers = ctx.jobs_of("serve")
    if not servers or ctx.traffic.loop != "open":
        return None
    steps = sum(ctx.edge_delta(j, "steps") for j in servers) / len(servers)
    return 1e3 * ctx.window_s / steps if steps else None
