"""The 95th percentile of the step times (call to synchronize), in ms, over
every step of a traced run's window after its traced first second: the
profiler lengthens the traced steps, so they are left out."""
import statistics

MODE = "step"


def read(ctx):
    calls = ctx.call_s[ctx.traced_calls:]
    if ctx.mode != MODE or ctx.trace is None or len(calls) < 20:
        return None
    return statistics.quantiles(calls, n=20, method="inclusive")[-1] * 1e3
