"""Seconds from the process's start to the first timed call: imports, the
scene's arrays, the program's plan, the warm-up and, in the first run of a
checkout, the build of the kernels."""


def read(ctx):
    return ctx.setup_s
