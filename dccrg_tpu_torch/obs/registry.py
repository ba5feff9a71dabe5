"""The metrics registry: counters, gauges, histograms, phase timers.

Design constraints:

* **zero-cost when disabled** — every recording method starts with a
  plain attribute check and returns before touching any dict, clock, or
  lock; a disabled registry records no keys at all;
* **thread-safe** — one lock guards every store (workloads drive grids
  from threads, e.g. overlap harnesses and the soak tool);
* **re-entrant phases** — ``phase("x")`` nested inside ``phase("x")``
  counts the OUTERMOST span's wall time once (the pre-obs
  ``PhaseTimers`` added both spans, double-counting; nesting depth is
  tracked per thread so concurrent outer spans on different threads
  still each count);
* **host-side only** — every recording site is host code that never
  synchronizes with the device: phase seconds are host enqueue time, and
  device time comes from the profiler merge (``obs.merge``).

Values are kept as plain Python scalars so a report JSON-serializes
without custom encoders.

A copy of the JAX package's ``obs/registry.py``; the one framework call,
the annotation a phase opens under ``profile_trace``, is
``torch.profiler.record_function`` here.  Series names, labels and the
report's layout are the JAX package's, so its consoles read the port's
exports unchanged.
"""
from __future__ import annotations

import math
import os
import threading
import time
import weakref
from contextlib import contextmanager

__all__ = ["MetricsRegistry", "metrics", "enable", "disable"]


def _labels_key(labels: dict) -> tuple:
    """Canonical hashable form of a label set."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


#: canonical label key -> its export string (``report()`` formats every
#: series each snapshot; a live stream snapshots every ~50 ms)
_LABEL_STRS: dict = {}


def _labels_str(key: tuple) -> str:
    s = _LABEL_STRS.get(key)
    if s is None:
        if len(_LABEL_STRS) > 65536:
            _LABEL_STRS.clear()
        s = _LABEL_STRS[key] = ",".join(f"{k}={v}" for k, v in key)
    return s


def _scalar(value):
    """numpy scalar/0-d array -> python scalar (JSON-clean storage)."""
    if hasattr(value, "item"):
        value = value.item()
    return value


class MetricsRegistry:
    """Structured metrics store with labels.

    ``inc``/``gauge``/``observe``/``phase`` are the write API; ``report``
    returns one nested plain-dict snapshot (the shape ``telemetry.json``
    carries).  A fresh registry can be built for isolation (tests); the
    process-wide default is ``obs.metrics``.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        #: when True, ``phase`` additionally opens a named
        #: ``torch.profiler.record_function`` span (opt-in via
        #: ``obs.profile_trace``)
        self.annotate = False
        self._lock = threading.Lock()
        self._counters: dict = {}   # (name, labelkey) -> number
        self._gauges: dict = {}     # (name, labelkey) -> number
        self._hists: dict = {}      # (name, labelkey) -> [count, sum, min, max, {exp: n}]
        self._phases: dict = {}     # name -> [total_s, count]
        self._tls = threading.local()
        #: deferred recorders (see :meth:`register_flusher`)
        self._flushers = weakref.WeakSet()
        #: optional event timeline fed every completed phase span
        #: (attached by ``obs.events`` for the process-wide registry;
        #: stays None for isolated test registries unless set)
        self.timeline = None
        #: optional flight recorder fed every completed phase span
        #: (attached by ``obs.flightrec`` for the process-wide registry —
        #: the always-on black box)
        self.recorder = None
        #: when truthy, every completed phase span ALSO lands in the
        #: ``phase.duration_s{phase=<name>}`` histogram via
        #: :meth:`observe_duration` — per-span latency distributions
        #: (quantiles via ``obs.slo``) without touching any call site.
        #: ``DCCRG_PHASE_HIST=0`` starts it off.
        self.duration_histograms = _phase_hist_default()
        #: per-histogram log-bucket resolution: buckets per octave
        #: (default 1 — the original power-of-two buckets).  The SLO
        #: plane registers its latency series at a finer grain so p99
        #: estimates resolve below the factor-2 default
        #: (:meth:`set_histogram_resolution`).
        self._hist_res: dict = {}
        #: phase name -> its ``phase.duration_s`` series key
        self._duration_keys: dict = {}

    # ------------------------------------------------------------- writes

    def inc(self, name: str, value=1, **labels) -> None:
        """Add ``value`` to a (monotonic) counter."""
        if not self.enabled:
            return
        key = (name, _labels_key(labels))
        value = _scalar(value)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def inc_many(self, items) -> None:
        """Batched counter adds under ONE lock acquisition — the hot-seam
        form (a halo exchange records ~10 series per dispatch).  ``items``
        is an iterable of ``(name, value)`` or ``(name, value, labels
        dict)`` tuples."""
        if not self.enabled:
            return
        with self._lock:
            for it in items:
                key = (it[0], _labels_key(it[2]) if len(it) > 2 else ())
                self._counters[key] = (
                    self._counters.get(key, 0) + _scalar(it[1])
                )

    def inc_batch(self, pairs) -> None:
        """Hot-path form of :meth:`inc_many` for PREPARED batches:
        ``pairs`` is a sequence of ``((name, labels_key), value)`` with
        the labels key already in :func:`_labels_key` canonical form —
        callers cache the whole batch (see ``parallel/halo.py``) so a
        dispatch costs one lock and a handful of dict adds."""
        if not self.enabled:
            return
        with self._lock:
            counters = self._counters
            for key, v in pairs:
                counters[key] = counters.get(key, 0) + v

    def register_flusher(self, obj) -> None:
        """Register a deferred recorder: an object with a
        ``telemetry_flush(discard=False)`` method that converts locally
        buffered observations into ``inc_batch`` calls.  Hot seams whose
        per-dispatch record is static (the halo engine) buffer a bare
        multiplicity per dispatch and materialize here — ``report()``
        flushes every registered recorder first, ``reset()`` discards
        their pending buffers.  Held by weak reference, so an
        epoch-retired schedule simply drops out."""
        self._flushers.add(obj)

    def _flush(self, discard: bool = False) -> None:
        for obj in tuple(self._flushers):
            try:
                obj.telemetry_flush(discard=discard)
            except Exception:  # noqa: BLE001 — telemetry must never raise
                pass

    def gauge(self, name: str, value, **labels) -> None:
        """Set a gauge to its latest value."""
        if not self.enabled:
            return
        key = (name, _labels_key(labels))
        value = _scalar(value)
        with self._lock:
            self._gauges[key] = value

    def set_histogram_resolution(self, name: str, per_octave: int) -> None:
        """Refine one histogram's log buckets to ``per_octave`` buckets
        per factor of two (upper edges ``2^(k/per_octave)``).  Applies to
        samples observed AFTER the call; exported bucket keys stay upper
        edges, so ``obs.slo`` merge/quantile consume either resolution.
        Register the same resolution in every process whose exports will
        be merged (bucket keys must coincide)."""
        with self._lock:
            self._hist_res[str(name)] = max(int(per_octave), 1)

    def observe(self, name: str, value, **labels) -> None:
        """Record a sample into a histogram (count/sum/min/max plus
        log buckets: a sample lands in the smallest ``le=2^(k/R)``
        bucket holding it, where ``R`` is the histogram's registered
        resolution — default 1, the power-of-two buckets; non-positive
        samples land in ``le=0``)."""
        if not self.enabled:
            return
        self._observe_key((name, _labels_key(labels)), float(_scalar(value)))

    def _observe_key(self, key: tuple, value: float) -> None:
        """:meth:`observe` of a float under its canonical series key."""
        if value <= 0.0:
            exp = None
        else:
            # v = m * 2^e with m in [0.5, 1): bucket (2^(e-1), 2^e] —
            # exact powers of two (m == 0.5) belong one bucket down
            m, exp = math.frexp(value)
            if m == 0.5:
                exp -= 1
            res = self._hist_res.get(key[0])
            if res is not None and res > 1:
                # smallest k with 2^(k/res) >= value, edge-exclusive
                # below: samples sitting exactly on an edge stay in
                # that edge's bucket (le semantics, like the octaves)
                k = math.ceil(math.log2(value) * res)
                while 2.0 ** (k / res) < value:      # fp guard
                    k += 1
                while 2.0 ** ((k - 1) / res) >= value:
                    k -= 1
                exp = k / res
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0, 0.0, value, value, {}]
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            h[4][exp] = h[4].get(exp, 0) + 1

    def phase_add(self, name: str, dt: float, args: dict | None = None) -> None:
        """Directly add one completed span to a phase — the hot-dispatch
        form for spans that are never self-nested (the halo exchange
        seam times with two ``perf_counter`` calls and this, skipping
        the contextmanager + nesting bookkeeping of :meth:`phase`).
        ``args`` go onto the span's timeline record."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._phases.get(name)
            if rec is None:
                self._phases[name] = [dt, 1]
            else:
                rec[0] += dt
                rec[1] += 1
        self._span_hooks(name, time.perf_counter() - dt, dt, args)

    def observe_duration(self, name: str, dt: float) -> None:
        """Phase-hook: record one completed phase span into
        the ``phase.duration_s{phase=<name>}`` histogram, so every
        existing phase timer feeds the latency-quantile plane
        (``obs.slo``) without new call sites.  Fired from :meth:`phase`
        / :meth:`phase_add` while :attr:`duration_histograms` is on;
        callable directly for spans timed outside the registry.  The
        series key of each phase name is built once (the halo seam calls
        this twice a step)."""
        if not self.enabled:
            return
        self._observe_key(self._duration_key(name), float(dt))

    def _duration_key(self, name: str) -> tuple:
        key = self._duration_keys.get(name)
        if key is None:
            key = self._duration_keys[name] = (
                "phase.duration_s", _labels_key({"phase": name}))
        return key

    def _span_hooks(self, name: str, begin: float, dt: float,
                    args: dict | None = None) -> None:
        """Everything a completed phase span feeds beyond the aggregate
        phase table: the event timeline, the per-phase duration
        histogram, and the flight recorder's ring."""
        tl = self.timeline
        if tl is not None and tl.enabled:
            tl.add(name, begin, dt, args)
        if self.duration_histograms:
            self.observe_duration(name, dt)
        fr = self.recorder
        if fr is not None and fr.enabled:
            fr.add_span(name, begin, dt)

    @contextmanager
    def phase(self, name: str):
        """Time a named phase.  Re-entrant: only the outermost span of a
        name (per thread) adds wall time and a completion, so recursive
        instrumented paths (e.g. a rebuild inside a migration) never
        double-count."""
        if not self.enabled:
            yield
            return
        depths = getattr(self._tls, "depths", None)
        if depths is None:
            depths = self._tls.depths = {}
        outer = depths.get(name, 0)
        depths[name] = outer + 1
        ann = None
        if self.annotate:
            try:
                from torch.profiler import record_function

                ann = record_function(name)
                ann.__enter__()
            except Exception:  # noqa: BLE001 — tracing must never break work
                ann = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            if outer == 0:
                del depths[name]
                with self._lock:
                    rec = self._phases.get(name)
                    if rec is None:
                        self._phases[name] = [dt, 1]
                    else:
                        rec[0] += dt
                        rec[1] += 1
                self._span_hooks(name, t0, dt)
            else:
                depths[name] = outer

    # -------------------------------------------------------------- reads

    def phase_names(self) -> set:
        with self._lock:
            return set(self._phases)

    def counter_value(self, name: str, **labels):
        """Current value of one counter (0 when never recorded)."""
        self._flush()
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0)

    def gauge_value(self, name: str, default=None, **labels):
        with self._lock:
            return self._gauges.get((name, _labels_key(labels)), default)

    def report(self) -> dict:
        """One plain-dict snapshot: ``{"phases", "counters", "gauges",
        "histograms"}``, every leaf a JSON-serializable scalar.  Metric
        names map to ``{label_string: value}`` (label string ``""`` for
        the unlabeled series)."""
        self._flush()

        def grouped(store):
            out: dict = {}
            for (name, lk), v in store.items():
                out.setdefault(name, {})[_labels_str(lk)] = v
            return {n: dict(sorted(s.items())) for n, s in sorted(out.items())}

        # hold the lock only for shallow copies of the raw stores —
        # sorting, label formatting and bucket stringification happen
        # outside, so a periodic stream snapshot (every ~50ms under a
        # live writer) never stalls the hot-path inc/observe callers
        # contending for the same lock
        with self._lock:
            phases_raw = dict(self._phases)
            counters_raw = dict(self._counters)
            gauges_raw = dict(self._gauges)
            hists_raw = {
                key: (cnt, tot, mn, mx, dict(buckets))
                for key, (cnt, tot, mn, mx, buckets)
                in self._hists.items()
            }
        phases = {
            name: {
                "total_s": round(t, 6),
                "count": c,
                "mean_s": round(t / max(c, 1), 6),
            }
            for name, (t, c) in sorted(phases_raw.items())
        }
        counters = grouped(counters_raw)
        gauges = grouped(gauges_raw)
        hists = {}
        for (name, lk), (cnt, tot, mn, mx, buckets) in sorted(
            hists_raw.items()
        ):
            hists.setdefault(name, {})[_labels_str(lk)] = {
                "count": cnt,
                "sum": tot,
                "mean": tot / max(cnt, 1),
                "min": mn,
                "max": mx,
                "buckets": {
                    "0" if e is None else str(2.0 ** e): n
                    for e, n in sorted(
                        buckets.items(),
                        key=lambda kv: (
                            -math.inf if kv[0] is None else kv[0]
                        ),
                    )
                },
            }
        return {
            "phases": phases,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }

    def reset(self) -> None:
        self._flush(discard=True)
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._phases.clear()


def _default_enabled() -> bool:
    return os.environ.get("DCCRG_TELEMETRY", "1").lower() not in (
        "0", "false", "off", "no",
    )


def _phase_hist_default() -> bool:
    return os.environ.get("DCCRG_PHASE_HIST", "1").lower() not in (
        "0", "false", "off", "no",
    )


#: process-wide default registry — the one every instrumented seam and
#: ``Grid.report()`` record into
metrics = MetricsRegistry(enabled=_default_enabled())


def enable() -> None:
    """Turn recording on for the process-wide registry."""
    metrics.enabled = True


def disable() -> None:
    """Turn recording off: every instrumented seam becomes a no-op
    attribute check (nothing is locked, timed, or stored)."""
    metrics.enabled = False
