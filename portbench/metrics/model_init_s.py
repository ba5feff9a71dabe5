"""Model layer: the program's set-up spans of the model, ``advection.init``
(face, flat or dense tables), ``advection.initialize_state`` and
``advection.set_cell_data`` (the seed's density loaded)."""
from portbench import spans


def read(ctx):
    return spans.phase_seconds(ctx, ["advection.init", "advection.initialize_state",
                                     "advection.set_cell_data"])
