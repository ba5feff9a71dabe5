"""Leaf updates completed in the window (leaves x steps, every chunk) over
the window's wall seconds, which end in a synchronise."""


def read(ctx):
    return ctx.units / ctx.window_s if ctx.window_s > 0 else None
