"""The 95th percentile of the window's frame times (call to synchronize),
in ms, over every frame of the window."""
import statistics

MODE = "frame"


def read(ctx):
    if ctx.mode != MODE or len(ctx.call_s) < 20:
        return None
    return statistics.quantiles(ctx.call_s, n=20, method="inclusive")[-1] * 1e3
