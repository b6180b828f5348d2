"""Share, in %, of the pixels that deferred shading shaded which K11 (the
hand-written shading kernel) shaded: the program's counters
``shade.fused`` over ``shade.pixels``, which count while the profiler
records (the traced frames).  The rest took the PyTorch replay.  None where
the program keeps no such counters or shaded no pixel."""

MODE = "frame"


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None:
        return None
    try:
        from tpurt_torch import trace
    except ImportError:
        return None
    counts = trace.snapshot()
    if not counts.get("shade.pixels"):
        return None
    return 100.0 * counts.get("shade.fused", 0) / counts["shade.pixels"]
