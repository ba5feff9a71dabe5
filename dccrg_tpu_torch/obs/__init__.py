"""Grid-wide telemetry: metrics registry, phase spans, trace export.

The JAX package's observability plane (``dccrg_tpu/obs``), ported: the
series names, labels and file formats are that package's byte for byte,
so its consoles (``tools/check_telemetry.py``, ``tools/slo_report.py``,
``tools/trace_report.py``) read the port's files unchanged.

* a process-wide :class:`MetricsRegistry` (``obs.metrics``) holding
  counters, gauges, histograms (all label-aware) and re-entrant,
  thread-safe phase timers;
* instrumentation wired into halo exchange (``parallel/halo.py``),
  epoch construction (``parallel/epoch.py``, ``parallel/epoch_delta.py``),
  load balancing and AMR commits (``grid.py``, ``amr/refinement.py``),
  checkpoint I/O (``io/checkpoint.py``), fault injection
  (``resilience/inject.py``), the CUDA builds (``cuda_build.py``) and the
  models' whole-run paths (``obs.fused``) — all recording from host code
  that never synchronises with the device;
* a JSON exporter (:func:`export_json` -> ``telemetry.json``), a streaming
  exporter (:func:`stream_to`, incremental JSONL snapshots) and a
  structured event timeline (``obs.timeline``, exportable as Chrome
  trace-event JSON with :func:`export_chrome_trace`);
* per-device memory gauges from the CUDA caching allocator
  (:func:`sample_hbm` -> ``hbm.bytes_in_use{device=d}``);
* the device timeline (``obs.kineto`` + ``obs.merge``):
  :func:`profile_trace` wraps ``torch.profiler`` (CUDA activity when a
  card is present) and writes Kineto's trace; the ingest recovers each
  device's kernels, copies and memsets, clock-aligns them on the host
  timeline through sync beacons, and merges them into one Chrome trace
  with measured gauges on top: ``overlap.fraction{phase=halo}``,
  ``device.busy_fraction{device=d}`` and per-kernel
  ``device.kernel_time_us{kernel}`` under the wrapper labels
  (``fused_run``, ``halo.ring_copy``, ...).  ``DCCRG_XPLANE=0`` opts out;
  a capture without device events is the documented no-op;
* the SLO plane (``obs.slo`` quantiles and merges, ``obs.flightrec``
  black box), its live side (``obs.live`` stream tailers and windowed
  views, ``obs.alerts`` rules) and its predictive side (``obs.cost``) —
  copies of the JAX package's modules.

Telemetry is on by default; ``disable()`` — or ``DCCRG_TELEMETRY=0`` in
the environment — makes every recording call a cheap early return that
touches no state at all.  The event timeline can be switched off
independently (``DCCRG_TIMELINE=0``).
"""
from .registry import MetricsRegistry, metrics, disable, enable
from .export import export_json
from .trace import profile_trace, trace_span
from .stream import TelemetryStream, stream_to, maybe_flush
from .events import (
    EventTimeline,
    timeline,
    span,
    export_chrome_trace,
    enable_timeline,
    disable_timeline,
)
from .hbm import sample_hbm
from . import fused
from . import slo
from . import live
from . import alerts
from . import cost
from . import kineto
from .flightrec import (
    FlightRecorder,
    recorder as flight_recorder,
    validate_flightrec,
)
from .merge import (
    ClockAlignment,
    MergedTrace,
    build_merged,
    build_from_capture,
    merge_profile,
    merge_chrome_traces,
    validate_merged_trace,
)

__all__ = [
    "MetricsRegistry",
    "metrics",
    "enable",
    "disable",
    "export_json",
    "profile_trace",
    "trace_span",
    "TelemetryStream",
    "stream_to",
    "maybe_flush",
    "EventTimeline",
    "timeline",
    "span",
    "export_chrome_trace",
    "enable_timeline",
    "disable_timeline",
    "sample_hbm",
    "fused",
    "slo",
    "live",
    "alerts",
    "cost",
    "kineto",
    "FlightRecorder",
    "flight_recorder",
    "validate_flightrec",
    "ClockAlignment",
    "MergedTrace",
    "build_merged",
    "build_from_capture",
    "merge_profile",
    "merge_chrome_traces",
    "validate_merged_trace",
]
