"""Model layer: bytes of the host arrays the program copies to the device a
chunk on the stepping and ``dt`` paths (``advection.h2d_bytes``, all
sites)."""
from portbench import spans


def read(ctx):
    return spans.counter_per_chunk(ctx, "advection.h2d_bytes")
