"""Device ms a frame of the traversal kernels K5-K7 (trace_records_kernel,
trace_bounce_kernel, trace_shadows_kernel)."""

MODE = "frame"
NAMES = ("trace_records_kernel", "trace_bounce_kernel", "trace_shadows_kernel")


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.kernel_seconds(lambda name: any(k in name for k in NAMES))
    return seconds * 1e3 / ctx.traced_calls if n else None
