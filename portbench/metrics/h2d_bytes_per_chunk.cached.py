"""``h2d_bytes_per_chunk``, read the same way, in the cells whose grid fits
the card's L2 (``cell_updates_per_s.cached``)."""
from portbench.metrics.h2d_bytes_per_chunk import read  # noqa: F401
