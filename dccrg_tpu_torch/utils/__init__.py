"""Host-side helpers (copied from the JAX package's ``utils``)."""
from .timers import PhaseTimers, timers

__all__ = ["PhaseTimers", "timers"]
