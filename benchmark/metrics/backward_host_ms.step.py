"""Host ms a step inside the program's span ``tpurt.backward``: the
``torch.autograd.grad`` call of the step on the window's thread, which
waits there while the autograd engine runs the card's backward nodes on
its own thread."""

MODE = "step"
SPAN = "tpurt.backward"


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or not ctx.traced_calls:
        return None
    if ctx.trace.window is None or not ctx.trace.spans.get(SPAN):
        return None
    return ctx.trace.span_seconds(SPAN) * 1e3 / ctx.traced_calls
