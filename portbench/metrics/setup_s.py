"""Seconds from the process's start to the first timed chunk: imports,
CUDA's start, the grid, the model, the inputs and the warm-up chunk (and
the first run in a checkout, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
