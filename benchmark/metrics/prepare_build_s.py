"""Host seconds of the program's last ``prepare``: the cluster (or grid)
build plus the upper level, the slot order and their upload, from the
program's gauge ``tpurt_torch.trace.prepare_seconds`` (part of setup_s)."""


def read(ctx):
    try:
        from tpurt_torch import trace
    except ImportError:
        return None
    got = getattr(trace, "prepare_seconds", None)
    if not got:
        return None
    return got["build"] + got["tree"]
