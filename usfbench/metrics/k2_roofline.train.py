"""K2 (the port's flash-attention forward, kernels named ``flash_fwd*``)
in a training cell's traced interval: the least time its
launches could take, over the device time they took. Each launch is a
training microbatch's causal attention (the forward, and remat's
recompute of it), whose least time is the larger of its flops over the
bf16 peak and its bytes (Q, K, V read and O written once) over HBM's."""

from usfbench.counting import flash_fwd_bound_s


def read(ctx):
    jobs = ctx.jobs_of("train")
    if ctx.trace is None or not jobs:
        return None
    n, busy = ctx.trace.launches("flash_fwd")
    if not n or not busy:
        return None
    spec, c = jobs[0].spec, ctx.conf
    H = c["num_attention_heads"]
    bound = flash_fwd_bound_s(spec["global_batch"] // spec["microbatches"],
                              spec["seq_len"], H, c["num_key_value_heads"],
                              c.get("head_dim") or c["hidden_size"] // H,
                              c["compute_dtype"])
    return 100.0 * n * bound / busy
