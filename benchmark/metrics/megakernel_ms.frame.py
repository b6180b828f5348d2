"""Device ms a frame of K1 (megakernel_fwd, the phase-1 plan's forward):
the kernels launched inside the program's span ``tpurt.megakernel``
(``megakernel.render_rows_fused``), over the traced frames."""

MODE = "frame"


def read(ctx):
    tr = ctx.trace
    if ctx.mode != MODE or tr is None or tr.window is None or not ctx.traced_calls:
        return None
    seconds, n = tr.launched_in(tr.span_intervals("tpurt.megakernel"))
    return seconds * 1e3 / ctx.traced_calls if n else None
