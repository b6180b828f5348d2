"""Kernels and copies a step launched inside the program's span
``tpurt.step``, or by the autograd engine's own thread while that span was
open (the backward's nodes)."""
from benchmark import spans
from benchmark.trace import Intervals

MODE = "step"


def read(ctx):
    tr = ctx.trace
    if ctx.mode != MODE or tr is None or tr.window is None or not ctx.traced_calls:
        return None
    step = spans.named(tr, "tpurt.step")
    if not step or not tr.device:
        return None
    inside = {tr.main_tid: Intervals(step)}
    for tid in tr.engine:
        if tid != tr.main_tid:
            inside[tid] = Intervals(spans.intersect(spans.engine_pairs(tr, tid), step))
    _, n = tr.launched_in(inside)
    return n / ctx.traced_calls if n else None
