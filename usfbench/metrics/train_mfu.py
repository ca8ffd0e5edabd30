"""Training model flops a second over the card's bf16 peak: the flops of
a token (6 a weight it multiplies by, and three times the causal
attention's forward; remat's recompute not counted) times the window's
training tokens a second."""

from usfbench.counting import PEAK_FLOPS, train_flops_per_token
from usfbench.generator import overlap_rate


def read(ctx):
    total = 0.0
    for j in ctx.jobs_of("train"):
        rate = overlap_rate(j.intervals, ctx.t_w0, ctx.t_w1)
        total += rate * train_flops_per_token(ctx.conf, j.spec["seq_len"])
    if not total:
        return None
    return 100.0 * total / PEAK_FLOPS[ctx.conf["compute_dtype"]]
