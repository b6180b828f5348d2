"""Share of the traced window, in %, in which the card ran no kernel and
no copy (torch.profiler's device activity)."""

MODE = "step"


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or ctx.trace.window is None:
        return None
    busy, window = ctx.trace.busy_window()
    if not ctx.trace.device or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
