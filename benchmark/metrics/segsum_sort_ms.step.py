"""Device ms a step of the work launched inside the program's span
``tpurt.segsum.sort``: the stable sort of each segment-sum stream, before
K8 (on the autograd engine's thread)."""

MODE = "step"


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.launched_in(ctx.trace.span_intervals("tpurt.segsum.sort"))
    return seconds * 1e3 / ctx.traced_calls if n else None
