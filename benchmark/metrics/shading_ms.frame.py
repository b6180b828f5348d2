"""Device ms a frame of the kernels launched inside deferred shading
(``shade_from_records``, wrapped in a span where the traversal module looks
it up)."""

SPANS = (("tpurt_torch.kernels.traversal", "shade_from_records", "shading"),)


def read(ctx):
    if ctx.mode != "frame" or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.launched_in(ctx.trace.span_intervals("shading"))
    return seconds * 1e3 / ctx.traced_calls if n else None
