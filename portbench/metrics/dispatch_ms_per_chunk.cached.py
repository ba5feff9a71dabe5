"""``dispatch_ms_per_chunk``, read the same way, in the cells whose grid fits the card's
L2 (``cell_updates_per_s.cached``): their runs spread more, so they carry
their own metrics and bound."""
from portbench.metrics.dispatch_ms_per_chunk import read  # noqa: F401
