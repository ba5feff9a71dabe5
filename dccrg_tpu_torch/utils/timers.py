"""Phase timers: a shim over the ``obs`` metrics registry.

A copy of the JAX package's ``utils/timers.py``:

* ``timers`` — the process-wide default, a view over ``obs.metrics`` so
  phases recorded by the instrumented seams (``epoch.build``,
  ``halo.exchange``, ...) appear in ``timers.report()``;
* ``PhaseTimers()`` — an isolated registry with the timer API
  (``phase``/``report``/``reset``/``total``/``count``/``enabled``).

A ``phase("x")`` nested inside ``phase("x")`` counts only the outermost
span per thread, under the registry's lock.  ``torch_trace`` is the JAX
package's ``jax_trace`` over ``obs.profile_trace``.
"""
from __future__ import annotations

from contextlib import contextmanager

from ..obs.registry import MetricsRegistry
from ..obs.registry import metrics as _global_metrics

__all__ = ["PhaseTimers", "timers", "torch_trace"]


class PhaseTimers:
    """The timer API, delegating to a :class:`MetricsRegistry`."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self._registry = (
            registry if registry is not None else MetricsRegistry()
        )

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._registry.enabled = bool(value)

    def phase(self, name: str):
        return self._registry.phase(name)

    def report(self) -> dict:
        return self._registry.report()["phases"]

    def reset(self):
        self._registry.reset()

    # raw accessors: {name: seconds} / {name: completions}
    @property
    def total(self) -> dict:
        return {n: rec["total_s"] for n, rec in self.report().items()}

    @property
    def count(self) -> dict:
        return {n: rec["count"] for n, rec in self.report().items()}


#: process-wide default registry (a view over ``obs.metrics``)
timers = PhaseTimers(registry=_global_metrics)


@contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a region, with a
    ``record_function`` span for every registry phase (``obs.
    profile_trace``)."""
    from ..obs.trace import profile_trace

    with profile_trace(log_dir, annotate=True):
        yield
