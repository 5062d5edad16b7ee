"""``setup_s``: seconds from the process's start to the first timed
operation: imports, the kernels' build or load, the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
