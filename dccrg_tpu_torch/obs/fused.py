"""Post-run reconciliation counters for fused whole-run kernels.

The whole-run paths (``Advection.run``'s dense and flat kernels, the GoL
board kernel, the Vlasov step kernel) keep their ghost traffic on the
device, out of the host halo seam's sight.  This closes the coverage gap
from the HOST side: one cheap record per ``run()`` call of

* ``fused.runs{model,path}``   — dispatches of a whole-run kernel,
* ``fused.steps{model,path}``  — device-side steps those dispatches ran,
* ``fused.halo_bytes_equiv{model,path}`` — ``steps x schedule bytes``,
  the ghost payload the host seam WOULD have moved for the same steps
  (0 on a single device, where the schedule really ships nothing).

``halo.bytes_moved`` (host seam) + ``fused.halo_bytes_equiv`` together
account for every step's ghost traffic, whichever path ran.

A copy of the JAX package's ``obs/fused.py``.
"""
from __future__ import annotations

from .registry import metrics

__all__ = ["record_run"]


def record_run(model: str, path: str, steps, bytes_per_step) -> None:
    """Record one whole-run dispatch.  A ``steps`` or ``bytes_per_step``
    that is not an integer skips the record."""
    if not metrics.enabled:
        return
    try:
        steps = int(steps)
        bps = int(bytes_per_step)
    except (TypeError, ValueError):
        return
    labels = {"model": model, "path": path}
    metrics.inc_many([
        ("fused.runs", 1, labels),
        ("fused.steps", steps, labels),
        ("fused.halo_bytes_equiv", steps * bps, labels),
    ])
