"""Opt-in ``torch.profiler`` tracing around instrumented phases.

``profile_trace(log_dir)`` captures a profiler trace (view in perfetto /
``chrome://tracing``) and, for its duration, makes every
``metrics.phase(...)`` span open a named ``record_function`` — so the
halo/epoch/LB/AMR/checkpoint seams show up as labeled host spans
alongside the device timeline.  The JAX package's ``obs/trace.py`` with
``torch.profiler`` in place of ``jax.profiler``.
"""
from __future__ import annotations

import os
import socket
import time
from contextlib import contextmanager

from .registry import metrics

__all__ = ["profile_trace", "trace_span"]


@contextmanager
def profile_trace(log_dir: str, annotate: bool = True, registry=None):
    """Capture a ``torch.profiler`` trace of the enclosed region and write
    Kineto's Chrome trace into ``log_dir`` on exit
    (``<host>_<pid>.<ns>.pt.trace.json``, the file ``obs.kineto.ingest``
    reads).  Yields the ``torch.profiler.profile`` object.

    The capture records the CPU, and CUDA activity when a card is present
    (``torch.cuda.is_available()``): without one there are no device
    events to record, and the ingest of such a capture is the documented
    no-op.

    ``annotate`` also switches the registry's phase spans to open
    ``record_function`` markers while the trace runs (restored after).
    Clock-sync beacons (``obs.kineto.emit_clock_sync``) are dropped at
    both ends of the capture: they let ``obs.merge`` place the captured
    device spans on the host ``EventTimeline`` clock.  Skipped under
    ``DCCRG_XPLANE=0``.  Stopping the profiler waits for the device, as
    flushing its activity records requires; nothing inside the region
    does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .kineto import emit_clock_sync

    reg = registry if registry is not None else metrics
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    prev = reg.annotate
    if annotate:
        reg.annotate = True
    prof = profile(activities=activities)
    prof.start()
    try:
        emit_clock_sync()
        yield prof
    finally:
        try:
            emit_clock_sync()
        finally:
            try:
                prof.stop()
            finally:
                reg.annotate = prev
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(str(log_dir), name))


@contextmanager
def trace_span(name: str):
    """A single named ``record_function`` span (host timeline marker)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
