"""Device ms a step of the kernels launched while the autograd engine
evaluated a backward function (deferred shading's and the pack's backward
nodes, the gathers' segment sums)."""


def read(ctx):
    if ctx.mode != "step" or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds, n = ctx.trace.launched_in(ctx.trace.engine)
    return seconds * 1e3 / ctx.traced_calls if n else None
