"""Device ms a step of the sorted segment-sum kernel K8 (segsum_kernel)."""


def read(ctx):
    if ctx.mode != "step" or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.kernel_seconds(lambda name: "segsum_kernel" in name)
    return seconds * 1e3 / ctx.traced_calls if n else None
