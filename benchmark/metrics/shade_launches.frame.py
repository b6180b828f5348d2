"""Kernels and copies a frame launched inside the program's span
``tpurt.shade`` (deferred shading)."""

MODE = "frame"


def read(ctx):
    tr = ctx.trace
    if ctx.mode != MODE or tr is None or tr.window is None or not ctx.traced_calls:
        return None
    _, n = tr.launched_in(tr.span_intervals("tpurt.shade"))
    return n / ctx.traced_calls if n else None
