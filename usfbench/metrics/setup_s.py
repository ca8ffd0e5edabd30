"""Seconds from the start of the process to the start of the window:
imports, weights, kernel builds, warm-up requests and the trainers' first
steps."""


def read(ctx):
    return ctx.t_w0 - ctx.t_proc0
