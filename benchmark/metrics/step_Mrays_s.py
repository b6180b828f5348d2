"""Nominal rays a second of the window: steps completed × the
configuration's nominal rays (pixels × depths × (1 + lights)) ÷ the
window's seconds, on the host clock, each step ended by a synchronize."""

MODE = "step"


def read(ctx):
    if ctx.mode != MODE or not ctx.call_s:
        return None
    return len(ctx.call_s) * ctx.nominal_rays / ctx.window_s / 1e6
