"""Streaming telemetry export: periodic incremental JSONL snapshots.

``export_json`` writes one snapshot at the end of a run — which is
exactly when a hung soak seed or a killed bench round never arrives.
The streamer appends a full registry snapshot as ONE JSON line every
``period`` seconds from a daemon thread (plus on demand and at exit),
each line flushed as it is written, so whatever happened before the
process died is on disk as complete, parseable lines:

    {"seq": 0, "ts": 1754300000.1, "phases": {...}, "counters": {...},
     "gauges": {...}, "histograms": {...}, ...extra}

``seq`` is strictly increasing and ``ts`` non-decreasing per file —
``tools/check_telemetry.py`` schema-validates both.  Counters are
cumulative (the registry's monotonic totals), so consumers diff
consecutive lines for rates.

Wired into ``tools/soak.py`` (per-subsystem child streams), ``bench.py``
(the real-measurement child) and ``tools/onchip_r3.py`` battery
children.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref

from .registry import metrics

__all__ = ["TelemetryStream", "stream_to", "maybe_flush"]

#: every STARTED stream, weakly held — the step-boundary flush seam
#: (``maybe_flush``) walks it so live windows move between timer ticks
_active: "weakref.WeakSet" = weakref.WeakSet()


def _flush_period() -> float:
    """``DCCRG_STREAM_FLUSH_S``: minimum seconds between step-boundary
    snapshots (default 1.0; <= 0 disables the seam entirely)."""
    try:
        return float(os.environ.get("DCCRG_STREAM_FLUSH_S", "1.0"))
    except ValueError:
        return 1.0


def maybe_flush(now: float | None = None) -> int:
    """Write a snapshot on every active stream whose last line is older
    than ``DCCRG_STREAM_FLUSH_S``.  Called from step boundaries (the
    ensemble scheduler) so live tailers see fresh windows even when the
    periodic ticker is slow; a cheap no-op when no stream is active.
    Returns the number of snapshots written; never raises."""
    if not _active:
        return 0
    period = _flush_period()
    if period <= 0:
        return 0
    now = time.time() if now is None else float(now)
    n = 0
    for s in tuple(_active):
        try:
            if now - s._last_ts >= period:
                s.write_snapshot()
                n += 1
        except Exception:  # noqa: BLE001 — never kill the workload
            pass
    return n


class TelemetryStream:
    """Appends registry snapshots to a JSONL file on a fixed period.

    Use as a context manager or ``start()``/``stop()``; ``stop`` (and
    interpreter exit, when started via :func:`stream_to`) writes one
    final snapshot so the last state always lands.  Failures inside the
    ticker are swallowed — telemetry must never take down the workload.
    """

    def __init__(self, path: str, period: float = 30.0, registry=None,
                 extra: dict | None = None, truncate: bool = False):
        self.path = str(path)
        self.period = float(period)
        self._registry = registry if registry is not None else metrics
        self._extra = dict(extra or {})
        self._seq = 0
        self._last_ts = 0.0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        if truncate:
            with open(self.path, "w"):
                pass

    # ------------------------------------------------------------ writes

    def write_snapshot(self, **extra) -> dict:
        """Append one snapshot line now (any thread).  Returns the
        record written."""
        rep = self._registry.report()
        with self._lock:
            ts = time.time()
            # wall clock can step backwards (NTP); the stream contract
            # is non-decreasing ts per file
            ts = max(ts, self._last_ts)
            self._last_ts = ts
            rec = {"seq": self._seq, "ts": round(ts, 6),
                   **self._extra, **extra, **rep}
            self._seq += 1
            line = json.dumps(rec, default=float)
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
        return rec

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "TelemetryStream":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="dccrg-telemetry-stream")
        self._thread = t
        t.start()
        _active.add(self)
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.period):
            try:
                self.write_snapshot()
            except Exception:  # noqa: BLE001 — never kill the workload
                pass

    def stop(self, final: bool = True) -> None:
        """Stop the ticker; ``final`` appends one last snapshot."""
        _active.discard(self)
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if final:
            try:
                self.write_snapshot(final=True)
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "TelemetryStream":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(final=True)


def stream_to(path: str, period: float = 30.0, registry=None,
              extra: dict | None = None, truncate: bool = False,
              at_exit: bool = True) -> TelemetryStream:
    """Start a streaming exporter to ``path`` and return it.  With
    ``at_exit`` (the default) a final snapshot + stop is registered via
    ``atexit``, so a child process that simply runs to completion (or is
    interrupted between ticks) still leaves its closing state — the
    one-call form the soak/bench/battery children use."""
    s = TelemetryStream(path, period=period, registry=registry, extra=extra,
                        truncate=truncate)
    s.start()
    if at_exit:
        atexit.register(s.stop, True)
    return s
