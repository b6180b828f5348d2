"""Host ms a frame inside the program's pack: pack_clusters on a clusters
plan, pack_scene on a phase-1 plan, each wrapped in a span where its
caller looks it up (the forward pack; its backward runs in the autograd
engine)."""

MODE = "frame"
SPANS = (("tpurt_torch.kernels.traversal", "pack_clusters", "pack"),
         ("tpurt_torch.kernels.megakernel", "pack_scene", "pack"))


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or not ctx.traced_calls:
        return None
    if not ctx.trace.spans.get("pack"):
        return None
    return ctx.trace.span_seconds("pack") * 1e3 / ctx.traced_calls
