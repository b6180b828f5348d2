"""Share of the traced window, in %, in which the card ran no kernel and
no copy while the window's thread was in none of the program's spans
(``tpurt.*``): idle time that no layer of the program names."""
from benchmark import spans

MODE = "frame"


def read(ctx):
    tr = ctx.trace
    if ctx.mode != MODE or tr is None or tr.window is None or not tr.device:
        return None
    mine = spans.program_spans(tr)
    if not mine:
        return None
    lo, hi = tr.window
    covered = spans.union(spans.busy(tr) + mine)
    return 100.0 * (1.0 - spans.length(covered) / (hi - lo))
