"""``advection_roofline``, read the same way, in the cells whose grid fits the card's
L2 (``cell_updates_per_s.cached``): their runs spread more, so they carry
their own metrics and bound."""
from portbench.metrics.advection_roofline import read  # noqa: F401
