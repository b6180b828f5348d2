"""Share, in %, of the segment-sum streams' entries whose index lies in
range: the program's counters ``segsum.live`` over ``segsum.entries``,
which count while the profiler records (the traced steps).  The rest are
dead lanes (background pixels, a gather's unused lanes) that K8 drops."""

MODE = "step"


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None:
        return None
    try:
        from tpurt_torch import trace
    except ImportError:
        return None
    counts = trace.snapshot()
    if not counts.get("segsum.entries"):
        return None
    return 100.0 * counts["segsum.live"] / counts["segsum.entries"]
