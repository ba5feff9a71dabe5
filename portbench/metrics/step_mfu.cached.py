"""``step_mfu``, read the same way, in the cells whose grid fits the card's
L2 (``cell_updates_per_s.cached``): their runs spread more, so they carry
their own metrics and bound."""
from portbench.metrics.step_mfu import read  # noqa: F401
