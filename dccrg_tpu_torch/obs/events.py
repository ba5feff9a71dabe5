"""Structured event timeline: begin/end spans with wall-clock anchors,
exportable as Chrome trace-event JSON (perfetto / ``chrome://tracing``).

The metrics registry's phase timers aggregate — total/count/mean per
phase name — which answers "where did the time go" but not "when".  The
timeline keeps the individual spans: every completed ``phase`` /
``phase_add`` on the registry (epoch rebuilds, halo flushes, LB
migrations, AMR commits, checkpoint I/O) lands here as one
``(name, begin, duration, thread)`` record, plus any explicit
``events.span(...)`` the caller opens.  Export produces matched ``B``/``E``
trace-event pairs on a microsecond timebase, viewable alongside the
``torch.profiler`` traces ``obs.profile_trace`` captures.  A copy of the
JAX package's ``obs/events.py``: the export's layout (its ``producer``
string included) is that package's, so its consoles read it unchanged.

Bounded: past ``max_events`` new spans are dropped (and counted) so a
soak run cannot grow host memory without limit — the aggregate registry
keeps counting regardless.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

from .registry import metrics

__all__ = [
    "EventTimeline",
    "timeline",
    "span",
    "export_chrome_trace",
    "enable_timeline",
    "disable_timeline",
    "HALO_FINISH",
]

#: args of the ``halo.exchange`` span that finishes a split exchange (a
#: ``halo.start``'s wait).  The port records every blocking exchange of a
#: model's step from the host too, where the JAX package's sit inside its
#: jitted step unseen; the merge pairs each ``halo.start`` with the next
#: span so marked, not with a step's own blocking exchange.
HALO_FINISH = {"halo": "finish"}


class _SpanContext:
    """Reusable context-args frame (see :meth:`EventTimeline.context`).
    A plain ``__slots__`` object, not a generator contextmanager: the
    halo seam enters one per dispatch, so entry must cost an append and
    a conditional dict merge, nothing more."""

    __slots__ = ("_tls", "_args")

    def __init__(self, tls, args):
        self._tls = tls
        self._args = args

    def __enter__(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append({**stack[-1], **self._args} if stack else self._args)
        return self

    def __exit__(self, *exc):
        self._tls.stack.pop()
        return False


class EventTimeline:
    """Thread-safe bounded span store with a common clock origin.

    Spans are recorded at END time (the recorder knows the duration by
    then); within one thread they come off a call stack, so they nest
    properly — the Chrome export reconstructs the B/E ordering from
    that property.
    """

    def __init__(self, enabled: bool = True, max_events: int = 65536):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events: list = []   # (name, begin_perf, dur_s, tid, args)
        self._dropped = 0
        self._ctx = threading.local()
        # clock anchor: perf_counter spans mapped onto wall time
        self._t0_perf = time.perf_counter()
        self._t0_wall = time.time()

    # ------------------------------------------------------------ writes

    def add(self, name: str, begin: float, duration: float,
            args: dict | None = None) -> None:
        """Record one completed span (``begin`` in ``perf_counter``
        time).  No-op when disabled or full (drops are counted, both
        locally and as the ``timeline.dropped`` registry counter, so a
        truncated timeline is never misread as a complete one)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        ctx = getattr(self._ctx, "stack", None)
        if ctx:
            args = {**ctx[-1], **args} if args else ctx[-1]
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                dropping = True
            else:
                dropping = False
                self._events.append(
                    (str(name), float(begin), max(float(duration), 0.0),
                     tid, args)
                )
        if dropping:
            metrics.inc("timeline.dropped")

    def context(self, **args):
        """Default span args for the calling thread: every span recorded
        while the context is open — registry phases included — carries
        these args (inner contexts layer on top, explicit span args win).
        The seam that makes concurrent grids separable in one trace:
        ``Grid`` opens ``context(grid_id=...)`` around its instrumented
        entry points, and workloads add ``context(step=i)`` around each
        step so every span attributes to its iteration.  The returned
        object is reusable and re-entrant — hot seams (the per-call halo
        dispatch) cache one instead of rebuilding it per dispatch."""
        return _SpanContext(self._ctx, args)

    @contextmanager
    def span(self, name: str, **args):
        """Explicit user span (the registry's phases feed the timeline
        automatically; this is for workload-level markers)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter() - t0, args or None)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # ------------------------------------------------------------- reads

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def summary(self) -> dict:
        with self._lock:
            return {"recorded": len(self._events), "dropped": self._dropped,
                    "max_events": self.max_events, "enabled": self.enabled}

    def spans(self) -> list:
        """Snapshot of the recorded spans as plain dicts (``begin`` in
        the timeline's ``perf_counter`` timebase) — the host half the
        device-timeline merge (``obs.merge``) consumes."""
        with self._lock:
            events = list(self._events)
        return [
            {"name": n, "begin": b, "dur": d, "tid": t,
             "args": dict(a) if a else None}
            for n, b, d, t, a in events
        ]

    def rebase(self, origin_perf: float, origin_wall: float = 0.0) -> None:
        """Move the timeline origin: spans keep their absolute ``begin``
        stamps, exports re-zero on the new origin.  Used by synthetic
        timelines built on a foreign clock (``obs.merge`` reconstructs a
        host track from a capture's own annotations when the live
        timeline is gone)."""
        self._t0_perf = float(origin_perf)
        self._t0_wall = float(origin_wall)

    @property
    def origin_perf(self) -> float:
        """``perf_counter`` stamp of the timeline origin (ts == 0)."""
        return self._t0_perf

    @property
    def origin_wall(self) -> float:
        """Wall-clock (unix) time of the timeline origin — the shared
        epoch-zero the cross-process fleet merge aligns traces on."""
        return self._t0_wall

    def wall_time(self, begin_perf: float) -> float:
        """Wall-clock time of a span's perf-counter begin stamp."""
        return self._t0_wall + (begin_perf - self._t0_perf)

    def chrome_trace(self) -> dict:
        """The timeline as a Chrome trace-event object: matched ``B``/``E``
        pairs per (pid, tid), timestamps in microseconds from the
        timeline origin.  Spans within a thread nest (they close in call
        order); a non-nested overlap — possible only through hand-fed
        ``add`` calls — is clamped into its enclosing span so the B/E
        stream stays stack-valid for any consumer."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        pid = os.getpid()
        by_tid: dict = {}
        for name, begin, dur, tid, args in events:
            by_tid.setdefault(tid, []).append((begin, -dur, name, args))
        out = []
        tids = sorted(by_tid)
        for short_tid, tid in enumerate(tids):
            spans = sorted(by_tid[tid])
            stack: list = []  # (end_time, name)

            def pop(until=None):
                while stack and (until is None or stack[-1][0] <= until):
                    end, nm = stack.pop()
                    out.append({
                        "name": nm, "ph": "E", "pid": pid, "tid": short_tid,
                        "ts": round((end - self._t0_perf) * 1e6, 3),
                    })

            for begin, neg_dur, name, args in spans:
                end = begin - neg_dur
                pop(until=begin)
                if stack and end > stack[-1][0]:
                    end = stack[-1][0]
                ev = {
                    "name": name, "ph": "B", "pid": pid, "tid": short_tid,
                    "ts": round((begin - self._t0_perf) * 1e6, 3),
                }
                if args:
                    ev["args"] = dict(args)
                out.append(ev)
                stack.append((end, name))
            pop()
        if dropped:
            # truncation is part of the trace itself, not just the
            # summary: an instant marker so a merged/archived trace is
            # never misread as a complete record
            out.append({
                "name": "timeline.truncated", "ph": "i", "s": "p",
                "pid": pid, "tid": 0,
                "ts": max((e["ts"] for e in out), default=0.0),
                "args": {"dropped_events": dropped,
                         "max_events": self.max_events},
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "origin_unix_s": self._t0_wall,
                "dropped_events": dropped,
                "producer": "dccrg_tpu.obs.events",
            },
        }


#: process-wide timeline, fed by every completed registry phase span.
#: ``DCCRG_TIMELINE=0`` starts it disabled (the registry's aggregate
#: phases keep recording either way).
timeline = EventTimeline(
    enabled=os.environ.get("DCCRG_TIMELINE", "1").lower() not in (
        "0", "false", "off", "no",
    )
)

# hook: MetricsRegistry.phase/phase_add feed completed spans here (see
# registry.py); attached from this side so registry.py has no import on
# the timeline module
metrics.timeline = timeline

span = timeline.span


def enable_timeline() -> None:
    timeline.enabled = True


def disable_timeline() -> None:
    timeline.enabled = False


def export_chrome_trace(path: str, tl: EventTimeline | None = None) -> dict:
    """Write the timeline as Chrome trace-event JSON to ``path`` (temp
    file + rename, like ``export_json``) and return the trace object.
    Load in perfetto / ``chrome://tracing`` next to the Kineto traces
    from ``obs.profile_trace``."""
    t = tl if tl is not None else timeline
    trace = t.chrome_trace()
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, default=float)
    os.replace(tmp, str(path))
    return trace
