"""Device ms a step of NCCL's kernels on rank 0's card (the image's
all_gather and the rank-order gradient sum), the wait for the other ranks
included."""


def read(ctx):
    if ctx.mode != "step" or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.kernel_seconds(lambda name: name.lower().startswith("nccl"))
    return seconds * 1e3 / ctx.traced_calls if n else None
