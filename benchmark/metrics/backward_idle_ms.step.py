"""Ms a step inside the program's span ``tpurt.backward`` in which the card
ran no kernel and no copy: the backward's wait on the host (the engine's
launches, its Python nodes), on the profiler's clock."""
from benchmark import spans

MODE = "step"


def read(ctx):
    tr = ctx.trace
    if ctx.mode != MODE or tr is None or tr.window is None or not ctx.traced_calls:
        return None
    backward = spans.named(tr, "tpurt.backward")
    if not backward or not tr.device:
        return None
    idle = spans.length(backward) - spans.length(spans.intersect(backward, spans.busy(tr)))
    return idle * 1e-3 / ctx.traced_calls
