"""``device_idle_share``, read the same way, in the cells whose grid fits the card's
L2 (``cell_updates_per_s.cached``): their runs spread more, so they carry
their own metrics and bound."""
from portbench.metrics.device_idle_share import read  # noqa: F401
