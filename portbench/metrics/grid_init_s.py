"""Host metadata: the program's ``grid.initialize`` span (level-0 cells,
partition, epoch and neighbour tables), inside the harness's
``grid_build``."""
from portbench import spans


def read(ctx):
    return spans.phase_seconds(ctx, ["grid.initialize"])
