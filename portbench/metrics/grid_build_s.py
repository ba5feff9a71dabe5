"""Host metadata: the harness's span around the program's grid build, its
refinement, the model's construction and ``initialize_state``."""


def read(ctx):
    return ctx.setup.get("grid_build")
