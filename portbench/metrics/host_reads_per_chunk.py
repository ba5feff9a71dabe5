"""Model layer: the program's blocking device-to-host reads a chunk on the
stepping and ``dt`` paths (``advection.host_reads``, all sites)."""
from portbench import spans


def read(ctx):
    return spans.counter_per_chunk(ctx, "advection.host_reads")
