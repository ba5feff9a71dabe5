"""Merged host+device timeline: one trace, and the measured overlap plane.

The host :class:`~dccrg_tpu_torch.obs.events.EventTimeline` ends every
span when the Python call returns — blind below the launch boundary.  The
Kineto ingest (``obs.kineto``) recovers what the devices actually ran, on
the profiler's own clock.  This module joins the two; it is the JAX
package's ``obs/merge.py`` over ``obs.kineto`` in place of ``obs.xplane``,
with the same summaries, gauges and trace layout:

* **clock alignment** — the profiler timebase is not the host
  ``perf_counter`` clock, so ``profile_trace`` drops clock-sync beacons
  whose names embed ``perf_counter_ns`` at emission;
  :class:`ClockAlignment` fits the offset (median over beacons, robust to
  scheduling jitter) that maps every device span onto the host
  timeline's microsecond timebase;
* **one merged Chrome trace** (:meth:`MergedTrace.to_chrome`) — host
  phases as the parent track (matched ``B``/``E`` pairs, exactly the
  ``EventTimeline`` export), one pid per device carrying its kernel
  spans as complete (``X``) events, and async ``b``/``e`` pairs spanning
  each halo kernel's host dispatch -> device completion;
* **measured gauges** (:meth:`MergedTrace.record_gauges`) —
  ``overlap.fraction{phase=halo}`` (the fraction of open host halo time
  during which the device was busy with interior compute),
  ``device.busy_fraction{device=d}``, and per-kernel
  ``device.kernel_time_us{kernel}`` attribution counters keyed by the
  wrapper labels of ``exec_cache.kernel_labels`` (a kernel's
  ``__global__`` symbol -> its label: ``fused_run``, ``halo.ring_copy``,
  ...);
* **fleet merge** (:func:`merge_chrome_traces`) — every process's
  merged trace records its wall-clock origin (``origin_unix_s``); the
  post-run step shifts them onto the shared epoch-zero and renumbers
  pids.

Everything degrades gracefully: no trace, no sync beacons, or no device
events (a CPU-only capture) produce a merged trace that is just the host
timeline plus a summary flagging the absent evidence — never an
exception on the telemetry path.
"""
from __future__ import annotations

import json
import os
import statistics

from .registry import metrics
from . import kineto as _xp
from .events import HALO_FINISH, EventTimeline, timeline as _default_timeline

__all__ = [
    "ClockAlignment",
    "MergedTrace",
    "build_merged",
    "build_from_capture",
    "merge_profile",
    "merge_chrome_traces",
    "validate_merged_trace",
]

#: pid namespace for device tracks in the merged trace (host keeps the
#: real os pid; chrome pids are arbitrary ints, they only need to be
#: distinct per track)
DEVICE_PID_BASE = 1_000_000

#: host-span name prefix whose open time defines the halo window the
#: overlap gauge measures
HALO_PHASE_PREFIX = "halo"


# ----------------------------------------------------------- intervals


def _union(ivs: list) -> list:
    """Merge ``(a, b)`` intervals into a disjoint sorted union."""
    out: list = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _intersect(u1: list, u2: list) -> list:
    """Intersection of two disjoint sorted unions."""
    out = []
    i = j = 0
    while i < len(u1) and j < len(u2):
        a = max(u1[i][0], u2[j][0])
        b = min(u1[i][1], u2[j][1])
        if a < b:
            out.append((a, b))
        if u1[i][1] <= u2[j][1]:
            i += 1
        else:
            j += 1
    return out


def _measure(u: list) -> float:
    return sum(b - a for a, b in u)


class ClockAlignment:
    """The fitted host<->trace clock relation.  ``offset_ns`` maps
    trace timestamps onto host ``perf_counter`` time
    (``perf_ns = trace_ns - offset_ns``); ``spread_ns`` is the beacon
    disagreement (scheduling jitter between taking the host stamp and
    the profiler recording the annotation), an honesty bound on span
    placement."""

    __slots__ = ("offset_ns", "n_syncs", "spread_ns")

    def __init__(self, offset_ns: float, n_syncs: int = 0,
                 spread_ns: float = 0.0):
        self.offset_ns = float(offset_ns)
        self.n_syncs = int(n_syncs)
        self.spread_ns = float(spread_ns)

    @classmethod
    def from_syncs(cls, pairs: list) -> "ClockAlignment | None":
        """Fit from ``(host_perf_ns, trace_ns)`` beacon pairs; the
        median offset rejects the occasional beacon that got descheduled
        between its two stamps.  None without pairs — alignment is then
        impossible and the merge stays host-only."""
        if not pairs:
            return None
        deltas = [x - p for p, x in pairs]
        return cls(statistics.median(deltas), len(pairs),
                   max(deltas) - min(deltas))

    def to_perf_s(self, trace_ns: float) -> float:
        return (trace_ns - self.offset_ns) / 1e9


# -------------------------------------------------------- merged trace


class MergedTrace:
    """Host timeline + aligned device execution lines on one clock.

    ``device_lines`` is ``[{device_id, name, kind, spans}]`` with each
    span ``{name, label, module, t0, t1}`` in MICROSECONDS from the host
    timeline origin; ``label`` is the wrapper label when the span's
    kernel symbol (``module``) maps back to one (else the raw symbol,
    else the event name)."""

    def __init__(self, timeline: EventTimeline, device_lines: list,
                 alignment: ClockAlignment | None,
                 plane_names: list | None = None):
        self.timeline = timeline
        self.device_lines = device_lines
        self.alignment = alignment
        self.plane_names = list(plane_names or [])
        self.host_spans = timeline.spans()

    # ------------------------------------------------------- summaries

    def _device_intervals(self, want_halo: bool | None = None) -> list:
        """Union over every device of span intervals (µs); ``want_halo``
        filters to halo-attributed (True) or interior-compute (False)
        spans."""
        ivs = []
        for line in self.device_lines:
            for s in line["spans"]:
                is_halo = str(s["label"]).startswith(HALO_PHASE_PREFIX)
                if want_halo is not None and is_halo != want_halo:
                    continue
                ivs.append((s["t0"], s["t1"]))
        return _union(ivs)

    def window_us(self) -> tuple:
        """(start, end) µs of the PROFILED window: the extent of the
        device evidence when there is any (the host timeline usually
        predates the capture — warmup spans must not dilute busy
        fractions), else the host span extent."""
        starts, ends = [], []
        for line in self.device_lines:
            for s in line["spans"]:
                starts.append(s["t0"])
                ends.append(s["t1"])
        if not starts:
            t0 = self.timeline.origin_perf
            for s in self.host_spans:
                a = (s["begin"] - t0) * 1e6
                starts.append(a)
                ends.append(a + s["dur"] * 1e6)
        if not starts:
            return (0.0, 0.0)
        return (min(starts), max(ends))

    def _halo_windows(self) -> list:
        """The collective in-flight windows (µs union): each
        ``halo.start`` dispatch begin paired with the end of the next
        ``halo.exchange`` span that finishes a split exchange (the
        finish/wait — the source paper's ``start_remote_neighbor_copies``
        / ``wait_remote_neighbor_copies`` split), marked ``HALO_FINISH``
        by the port; a timeline with no marked span (the JAX package's)
        pairs with the next ``halo.exchange`` of any kind.  Every
        ``halo.exchange`` span is a window too.  A workload that only
        ever used blocking exchanges has no start spans; its dispatch
        spans ARE the windows."""
        import bisect

        t0 = self.timeline.origin_perf
        starts, finishes, marked = [], [], []
        for s in self.host_spans:
            a = (s["begin"] - t0) * 1e6
            b = a + s["dur"] * 1e6
            if s["name"] == "halo.start":
                starts.append((a, b))
            elif s["name"] == "halo.exchange":
                finishes.append((a, b))
                if (s.get("args") or {}).get("halo") == HALO_FINISH["halo"]:
                    marked.append((a, b))
        if not starts:
            return _union(finishes)
        windows = list(finishes)
        closers = sorted(marked or finishes)
        fin_begins = [a for a, _b in closers]
        for a, b in starts:
            i = bisect.bisect_left(fin_begins, a)
            windows.append((a, closers[i][1]) if i < len(closers)
                           else (a, b))
        return _union(windows)

    def summary(self) -> dict:
        """The measured overlap/attribution plane as one plain dict:
        per-device busy fractions, per-kernel device-time attribution
        (keyed by wrapper labels where the kernel symbol maps back),
        and the halo overlap fraction — device interior-compute time
        inside the open host halo window, over the window."""
        w0, w1 = self.window_us()
        window_us = max(w1 - w0, 0.0)
        devices = {}
        for line in self.device_lines:
            u = _union([(s["t0"], s["t1"]) for s in line["spans"]])
            busy = _measure(u)
            devices[line["device_id"]] = {
                "kind": line["kind"],
                "line": line["name"],
                "busy_s": round(busy / 1e6, 6),
                "fraction": round(busy / window_us, 6) if window_us else 0.0,
                "spans": len(line["spans"]),
            }
        kernels: dict = {}
        for line in self.device_lines:
            for s in line["spans"]:
                rec = kernels.setdefault(
                    s["label"], {"time_us": 0.0, "count": 0,
                                 "module": s["module"]}
                )
                rec["time_us"] += s["t1"] - s["t0"]
                rec["count"] += 1
        for rec in kernels.values():
            rec["time_us"] = round(rec["time_us"], 3)
        kernels = dict(sorted(kernels.items(),
                              key=lambda kv: -kv[1]["time_us"]))
        # overlap: device interior-compute time inside the collective
        # in-flight windows, both clipped to the profiled window — the
        # measured form of "halo cost hidden under compute"
        clip = [(w0, w1)] if window_us else []
        halo_u = _intersect(self._halo_windows(), clip)
        compute_u = _intersect(self._device_intervals(want_halo=False),
                               clip)
        halo_dev_u = _intersect(self._device_intervals(want_halo=True),
                                clip)
        halo_s = _measure(halo_u) / 1e6
        overlap_s = _measure(_intersect(halo_u, compute_u)) / 1e6
        overlap = {
            "inflight_s": round(halo_s, 6),
            "device_compute_s": round(_measure(compute_u) / 1e6, 6),
            "device_collective_s": round(_measure(halo_dev_u) / 1e6, 6),
            "overlap_s": round(overlap_s, 6),
            "fraction": (round(overlap_s / halo_s, 6) if halo_s > 0
                         else None),
        }
        return {
            "window_s": round(window_us / 1e6, 6),
            "aligned": self.alignment is not None,
            "alignment": (
                {"offset_ns": self.alignment.offset_ns,
                 "n_syncs": self.alignment.n_syncs,
                 "spread_ns": self.alignment.spread_ns}
                if self.alignment else None
            ),
            "device_evidence": any(l["spans"] for l in self.device_lines),
            "host_spans": len(self.host_spans),
            "device_spans": sum(len(l["spans"])
                                for l in self.device_lines),
            "devices": devices,
            "kernels": kernels,
            "overlap": {"halo": overlap},
        }

    def host_gaps(self, min_us: float = 100.0, top: int = 10) -> list:
        """Host-gap hunting: windows where EVERY device sat idle, with
        the host phases that were open — where to look when device
        utilization is the bottleneck.  Sorted longest first."""
        w0, w1 = self.window_us()
        busy = self._device_intervals()
        if not busy or w1 <= w0:
            return []
        gaps = []
        prev = w0
        for a, b in busy:
            if a - prev >= min_us:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 - prev >= min_us:
            gaps.append((prev, w1))
        t0 = self.timeline.origin_perf
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            open_phases = sorted({
                s["name"] for s in self.host_spans
                if (s["begin"] - t0) * 1e6 < b
                and (s["begin"] - t0 + s["dur"]) * 1e6 > a
            })
            out.append({"start_us": round(a, 3), "dur_us": round(b - a, 3),
                        "open_host_phases": open_phases})
        return out

    def record_gauges(self, registry=None, extra_labels=None) -> dict:
        """Register the measured plane into the metrics registry:
        ``overlap.fraction{phase=halo}``,
        ``device.busy_fraction{device=d}`` and the per-kernel
        ``device.kernel_time_us{kernel}`` counters.  Returns the
        summary the gauges came from.  Recorded only from evidence — a
        deviceless round registers nothing (the documented no-op), so a
        gate requiring the gauges fails exactly when evidence went
        missing.

        ``extra_labels`` adds labels to the overlap gauge only (a probe
        profiling one model's split-phase drive records
        ``overlap.fraction{model=..., phase=halo}`` — the per-model
        series ``telemetry_diff``'s floor gate watches);
        per-device busy and per-kernel attribution stay global."""
        reg = registry if registry is not None else metrics
        s = self.summary()
        if not s["device_evidence"]:
            return s
        frac = s["overlap"]["halo"]["fraction"]
        if frac is not None:
            reg.gauge("overlap.fraction", frac, phase="halo",
                      **(extra_labels or {}))
        for dev, rec in s["devices"].items():
            reg.gauge("device.busy_fraction", rec["fraction"], device=dev)
        for label, rec in s["kernels"].items():
            reg.inc("device.kernel_time_us", int(rec["time_us"]),
                    kernel=label)
        return s

    # ---------------------------------------------------- chrome export

    def to_chrome(self, max_spans_per_device: int | None = None) -> dict:
        """One merged Chrome trace: the host timeline's matched B/E
        pairs (parent track), one pid per device with kernel spans as
        complete ``X`` events, and async ``b``/``e`` pairs spanning each
        collective's host dispatch -> device completion.

        ``max_spans_per_device`` compacts the export: only the longest
        N spans per device are written (a CPU probe captures tens of
        thousands of µs-thunks — raw evidence for the in-memory gauges,
        noise in a committed artifact).  Dropped counts land in
        ``otherData.device_spans_dropped`` so a compacted trace is never
        misread as complete; gauges/summaries always use the full
        span set."""
        trace = self.timeline.chrome_trace()
        events = trace["traceEvents"]
        host_pid = os.getpid()
        events.append({
            "name": "process_name", "ph": "M", "pid": host_pid,
            "args": {"name": f"host (pid {host_pid})"},
        })
        t0 = self.timeline.origin_perf
        # host halo dispatch begins, time-ordered, for b/e pairing
        halo_hosts = sorted(
            (s["begin"] - t0) * 1e6 for s in self.host_spans
            if s["name"] == HALO_PHASE_PREFIX
            or s["name"].startswith(HALO_PHASE_PREFIX + ".")
        )
        device_pids = {}
        spans_dropped: dict = {}
        flow_id = 0
        for line in self.device_lines:
            pid = DEVICE_PID_BASE + int(line["device_id"])
            device_pids[str(pid)] = line["device_id"]
            events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"device:{line['device_id']} "
                                 f"({line['kind']})"},
            })
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": line["name"]},
            })
            spans = line["spans"]
            if (max_spans_per_device is not None
                    and len(spans) > max_spans_per_device):
                spans_dropped[str(line["device_id"])] = (
                    len(spans) - max_spans_per_device
                )
                spans = sorted(spans, key=lambda s: s["t0"] - s["t1"]
                               )[:max_spans_per_device]
            for s in sorted(spans, key=lambda s: s["t0"]):
                ev = {
                    "name": s["label"], "cat": "device", "ph": "X",
                    "pid": pid, "tid": 0,
                    "ts": round(s["t0"], 3),
                    "dur": round(s["t1"] - s["t0"], 3),
                }
                if s["module"]:
                    # the JAX package's key names, so its consoles read
                    # the port's merged traces unchanged
                    ev["args"] = {"hlo_module": s["module"],
                                  "op": s["name"]}
                events.append(ev)
                if not str(s["label"]).startswith(HALO_PHASE_PREFIX):
                    continue
                # async in-flight window: host dispatch -> device done.
                # Pair with the latest host halo dispatch at or before
                # the device span (same-clock after alignment); spans
                # with no dispatch evidence stay unpaired.
                import bisect

                i = bisect.bisect_right(halo_hosts, s["t0"]) - 1
                if i < 0:
                    continue
                flow_id += 1
                events.append({
                    "name": s["label"], "cat": "collective", "ph": "b",
                    "id": str(flow_id), "pid": pid, "tid": 1,
                    "ts": round(halo_hosts[i], 3),
                })
                events.append({
                    "name": s["label"], "cat": "collective", "ph": "e",
                    "id": str(flow_id), "pid": pid, "tid": 1,
                    "ts": round(s["t1"], 3),
                })
        trace["otherData"].update({
            "producer": "dccrg_tpu.obs.merge",
            "host_pid": host_pid,
            "device_pids": device_pids,
            "aligned": self.alignment is not None,
            "alignment_offset_ns": (
                self.alignment.offset_ns if self.alignment else None
            ),
        })
        if spans_dropped:
            trace["otherData"]["device_spans_dropped"] = spans_dropped
        return trace

    def export(self, path: str,
               max_spans_per_device: int | None = None) -> dict:
        """Write :meth:`to_chrome` to ``path`` (tmp + rename)."""
        trace = self.to_chrome(max_spans_per_device=max_spans_per_device)
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f, default=float)
        os.replace(tmp, str(path))
        return trace


def _kernel_labels() -> dict:
    from ..parallel.exec_cache import kernel_labels

    return kernel_labels()


def _label(module, name, labels: dict, prefixes: list):
    """The attribution label of one span: its kernel symbol's label, by
    exact match or else by the longest label key the symbol starts with
    (Kineto's names vary between torch versions), else the raw symbol,
    else the event name."""
    if module is None:
        return name
    got = labels.get(module)
    if got is not None:
        return got
    for key in prefixes:
        if module.startswith(key):
            return labels[key]
    return module


def build_merged(ingest: "_xp.XIngest | None" = None,
                 log_dir: str | None = None,
                 timeline: EventTimeline | None = None,
                 alignment: ClockAlignment | None = None,
                 kernel_labels: dict | None = None) -> MergedTrace:
    """Join a Kineto ingest with a host timeline.  Alignment defaults
    to fitting the ingest's clock-sync beacons; without beacons the
    device half is dropped (unplaceable spans would be lies, not data)
    and the result is flagged ``aligned=False``."""
    tl = timeline if timeline is not None else _default_timeline
    if ingest is None:
        ingest = (_xp.ingest(log_dir) if log_dir is not None
                  else _xp.XIngest([], [], [], []))
    if alignment is None:
        alignment = ClockAlignment.from_syncs(_xp.clock_syncs(ingest))
    labels = kernel_labels if kernel_labels is not None else _kernel_labels()
    prefixes = sorted(labels, key=len, reverse=True)
    t0 = tl.origin_perf
    device_lines = []
    if alignment is not None:
        for line in ingest.exec_lines:
            spans = []
            for s in line.spans:
                a = (alignment.to_perf_s(s.start_ns) - t0) * 1e6
                spans.append({
                    "name": s.name,
                    "module": s.module,
                    "label": _label(s.module, s.name, labels, prefixes),
                    "t0": a,
                    "t1": a + s.dur_ns / 1e3,
                })
            device_lines.append({
                "device_id": line.device_id,
                "name": line.name,
                "kind": line.kind,
                "spans": spans,
            })
    return MergedTrace(tl, device_lines, alignment, ingest.plane_names)


def build_from_capture(ingest_or_dir) -> MergedTrace:
    """Post-hoc merge of a capture from ANOTHER process (or an earlier
    run): the live host timeline is gone, so the host track is
    reconstructed from the capture's own ``record_function`` markers —
    the phase spans ``profile_trace(annotate=True)`` emitted.  Host and
    device evidence then share the profiler clock, so alignment is the
    identity; the trade is that only annotated phases (not every
    timeline span) appear on the host track."""
    ing = (ingest_or_dir if isinstance(ingest_or_dir, _xp.XIngest)
           else _xp.ingest(ingest_or_dir))
    tl = EventTimeline(enabled=True)
    sync_prefix = _xp.CLOCK_SYNC_TAG + ":"
    begins = []
    for m in ing.markers:
        if m.name.startswith(sync_prefix) or m.dur_ns <= 0:
            continue
        tl.add(m.name, m.start_ns / 1e9, m.dur_ns / 1e9)
        begins.append(m.start_ns)
    for line in ing.exec_lines:
        begins.extend(s.start_ns for s in line.spans)
    tl.rebase(min(begins) / 1e9 if begins else 0.0)
    return build_merged(ingest=ing, timeline=tl,
                        alignment=ClockAlignment(0.0, 0, 0.0))


def merge_profile(log_dir: str, timeline: EventTimeline | None = None,
                  out_path: str | None = None, registry=None,
                  out_max_spans: int | None = None,
                  extra_labels: dict | None = None):
    """One-call round: ingest ``log_dir``, align, merge with the (default)
    host timeline, record the overlap/busy/attribution gauges, and
    optionally export the merged trace.  Returns ``(merged, summary)``.
    On a deviceless capture the summary's ``device_evidence`` is False
    and no gauge is recorded — the caller decides whether that is a
    failure (CI on a device host) or the documented no-op (CPU backends
    emitting no planes)."""
    reg = registry if registry is not None else metrics
    # the JAX package's phase names
    with reg.phase("xplane.ingest"):
        ing = _xp.ingest(log_dir)
    with reg.phase("trace.merge"):
        merged = build_merged(ingest=ing, timeline=timeline)
    summary = merged.record_gauges(registry, extra_labels=extra_labels)
    if out_path is not None:
        merged.export(out_path, max_spans_per_device=out_max_spans)
    return merged, summary


# --------------------------------------------------------- fleet merge


def merge_chrome_traces(sources: list, out_path: str | None = None) -> dict:
    """Unify per-process merged traces into one fleet trace.  Every
    source (a path or an already-loaded trace dict) must carry
    ``otherData.origin_unix_s`` — the wall-clock anchor each process's
    timeline origin recorded; the earliest origin becomes the fleet's
    shared epoch-zero and every event shifts onto it.  Pids are
    renumbered per process so soak / multiprocess-battery children
    cannot collide, with process_name metadata rewritten to say which
    child each track came from."""
    loaded = []
    for src in sources:
        if isinstance(src, (str, os.PathLike)):
            with open(src) as f:
                loaded.append((os.path.basename(str(src)), json.load(f)))
        else:
            loaded.append((f"proc{len(loaded)}", src))
    origins = []
    for name, tr in loaded:
        o = (tr.get("otherData") or {}).get("origin_unix_s")
        if o is None:
            raise ValueError(
                f"fleet merge: {name} carries no origin_unix_s anchor"
            )
        origins.append(float(o))
    epoch0 = min(origins) if origins else 0.0
    events = []
    pid_map: dict = {}
    sources_meta = []
    for i, ((name, tr), origin) in enumerate(zip(loaded, origins)):
        shift_us = (origin - epoch0) * 1e6
        sources_meta.append({"source": name, "origin_unix_s": origin,
                             "shift_us": round(shift_us, 3)})
        for ev in tr.get("traceEvents", []):
            ev = dict(ev)
            key = (i, ev.get("pid"))
            if key not in pid_map:
                pid_map[key] = len(pid_map) + 1
            ev["pid"] = pid_map[key]
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                base = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{name}: {base}" if base else name}
            events.append(ev)
    fleet = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "dccrg_tpu.obs.merge (fleet)",
            "origin_unix_s": epoch0,
            "sources": sources_meta,
        },
    }
    if out_path is not None:
        tmp = str(out_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(fleet, f, default=float)
        os.replace(tmp, str(out_path))
    return fleet


# ---------------------------------------------------------- validation


def validate_merged_trace(path_or_trace) -> list:
    """Schema-validate a merged (or fleet) trace: host ``B``/``E`` pairs
    matched in stack order per (pid, tid) with monotonic timestamps,
    ``X`` events non-negative and time-ordered per device track, every
    device pid distinct with a ``process_name`` metadata record, and
    every async ``b`` closed by a same-id ``e`` no earlier than its
    begin.  Returns failure strings (empty = valid)."""
    if isinstance(path_or_trace, dict):
        data = path_or_trace
    else:
        try:
            with open(path_or_trace) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"merged trace unreadable: {e}"]
    events = data.get("traceEvents")
    if not isinstance(events, list):
        return ["merged trace has no traceEvents list"]
    failures: list = []
    stacks: dict = {}
    last_ts: dict = {}
    last_x: dict = {}
    named_pids = set()
    async_open: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            failures.append(f"event {i}: not a trace event")
            continue
        ph = ev["ph"]
        pid = ev.get("pid")
        key = (pid, ev.get("tid"))
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(pid)
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            failures.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph in ("B", "E"):
            if ts < last_ts.get(key, float("-inf")):
                failures.append(
                    f"event {i}: ts {ts} went backwards on {key}"
                )
            last_ts[key] = ts
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append((ev.get("name"), ts))
            elif not stack:
                failures.append(
                    f"event {i}: E {ev.get('name')!r} with empty stack "
                    f"on {key}"
                )
            else:
                bname, bts = stack.pop()
                if bname != ev.get("name"):
                    failures.append(
                        f"event {i}: E {ev.get('name')!r} closes "
                        f"B {bname!r}"
                    )
                if ts < bts:
                    failures.append(
                        f"event {i}: span {bname!r} ends before it begins"
                    )
        elif ph == "X":
            if ev.get("dur", 0) < 0:
                failures.append(f"event {i}: X with negative dur")
            if ts < last_x.get(key, float("-inf")):
                failures.append(
                    f"event {i}: X events out of order on {key}"
                )
            last_x[key] = ts
        elif ph == "b":
            async_open[(pid, ev.get("id"))] = (i, ts)
        elif ph == "e":
            opened = async_open.pop((pid, ev.get("id")), None)
            if opened is None:
                failures.append(
                    f"event {i}: async e id={ev.get('id')!r} never began"
                )
            elif ts < opened[1]:
                failures.append(
                    f"event {i}: async id={ev.get('id')!r} ends before "
                    f"its begin"
                )
    for key, stack in stacks.items():
        if stack:
            failures.append(
                f"{key}: {len(stack)} unmatched B events "
                f"({[n for n, _ in stack]})"
            )
    for (pid, aid), (i, _ts) in async_open.items():
        failures.append(f"event {i}: async b id={aid!r} never ended")
    # every X-bearing pid must be named (one pid per device, labeled)
    for key in last_x:
        if key[0] not in named_pids:
            failures.append(
                f"pid {key[0]}: device track has no process_name metadata"
            )
    return failures
