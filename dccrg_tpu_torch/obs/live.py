"""Live fleet telemetry: stream tailers, windowed views, exposition.

The post-hoc SLO plane (``obs/slo.py``) computes quantiles from exported
snapshots after a run ends.  This module is the LIVE side: it tails the
per-process ``*.stream.jsonl`` files the registry already writes
(``obs/stream.py``), resumes from byte offsets, tolerates torn tails,
counts sequence gaps, and merges counters and log-bucket histograms
across processes using the exact-merge property ``slo.merge`` proved
(merging per-process exports equals pooling the samples).

Sliding windows come from the cumulative-snapshot structure of the
stream: every line is the registry's FULL state at write time, so the
windowed value of any series over ``[now - W, now]`` is the bucket-wise
difference between the latest snapshot and the newest snapshot at or
before the window edge.  No per-sample storage is needed — the window
math is a subtraction of two exports per file, then an exact cross-file
merge.

Stdlib-only: consoles and controllers tail a fleet without importing
torch.  A copy of the JAX package's ``obs/live.py`` without its file-load
fallback (the consoles load the JAX package's copy; the stream format is
the same).
"""
from __future__ import annotations

import collections
import glob
import json
import os
import pathlib
import threading
import time

from .slo import (
    deadline_miss_rates as _slo_miss_rates,
    merge as _slo_merge,
    merge_series as _slo_merge_series,
    quantile as _slo_quantile,
)
from .registry import metrics as _metrics

__all__ = [
    "StreamTailer",
    "FleetAggregator",
    "FleetView",
    "default_window_s",
    "discover_streams",
    "to_prometheus",
    "parse_prometheus",
]


def default_window_s() -> float:
    """Sliding-window span in seconds (``DCCRG_LIVE_WINDOW_S``, 60)."""
    try:
        w = float(os.environ.get("DCCRG_LIVE_WINDOW_S", "60"))
    except ValueError:
        w = 60.0
    return w if w > 0 else 60.0


def discover_streams(root) -> list:
    """``*.stream.jsonl`` files under ``root`` (a dir, glob, or file)."""
    root = str(root)
    if os.path.isdir(root):
        pat = os.path.join(root, "**", "*.stream.jsonl")
        return sorted(glob.glob(pat, recursive=True))
    if any(ch in root for ch in "*?["):
        return sorted(glob.glob(root))
    return [root] if os.path.exists(root) else []


class StreamTailer:
    """Incremental reader of ONE ``*.stream.jsonl`` file.

    Generalizes the heartbeat monitor's read loop: each ``poll()`` reads
    only the bytes appended since the last call (byte-offset resume), so
    tailing is O(new data) regardless of file size.  A torn final line —
    the writer is mid-``write`` — is buffered and re-joined on the next
    poll once the newline lands; it is counted (``torn_tails``) only
    when a poll actually left a fragment behind.  Sequence gaps (a
    writer restarted with ``truncate=False``, or lines lost to a copy)
    are counted in ``seq_gaps``; undecodable lines in ``bad_lines``.
    Truncation (file shrank below our offset) restarts from zero.
    """

    def __init__(self, path, registry=None):
        self.path = str(path)
        self.offset = 0
        self.records_read = 0
        self.seq_gaps = 0
        self.torn_tails = 0
        self.bad_lines = 0
        self.last_seq = None
        self._tail = b""
        self._registry = registry if registry is not None else _metrics

    def _count(self, name, n=1):
        reg = self._registry
        if reg is not None and getattr(reg, "enabled", False):
            reg.inc(name, n, path=os.path.basename(self.path))

    def poll(self) -> list:
        """Parse and return the records appended since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:  # truncated/rotated: start over
            self.offset = 0
            self._tail = b""
            self.last_seq = None
        if size <= self.offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            chunk = f.read(size - self.offset)
        self.offset += len(chunk)
        buf = self._tail + chunk
        *lines, self._tail = buf.split(b"\n")
        if self._tail:
            # the writer was mid-line; the fragment re-joins next poll
            self.torn_tails += 1
            self._count("stream.torn_tails")
        out = []
        for raw in lines:
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                self.bad_lines += 1
                self._count("stream.bad_lines")
                continue
            if not isinstance(rec, dict):
                self.bad_lines += 1
                self._count("stream.bad_lines")
                continue
            seq = rec.get("seq")
            if isinstance(seq, int):
                if self.last_seq is not None and seq > self.last_seq + 1:
                    gap = seq - self.last_seq - 1
                    self.seq_gaps += gap
                    self._count("stream.seq_gaps", gap)
                self.last_seq = seq
            self.records_read += 1
            out.append(rec)
        return out


def _sub_counters(latest: dict, edge: dict) -> dict:
    """Windowed counter series: latest minus the window-edge snapshot
    (missing at the edge means the series started inside the window).
    Negative deltas (a registry reset) clamp to the latest value."""
    out: dict = {}
    for name, series in (latest or {}).items():
        base = (edge or {}).get(name) or {}
        dst = {}
        for label, v in (series or {}).items():
            d = v - base.get(label, 0)
            dst[label] = v if d < 0 else d
        if dst:
            out[name] = dst
    return out


def _sub_hist(latest: dict, edge: dict) -> dict:
    """Bucket-delta of two cumulative histogram exports of one series.

    count/sum/buckets subtract; ``min``/``max`` keep the cumulative
    envelope (the window's true extrema are unrecoverable, and clamping
    a window quantile into the cumulative envelope is always sound
    because the window's samples are a subset).  A negative count — the
    writer's registry was reset — falls back to the latest cumulative
    state."""
    if not latest or not latest.get("count"):
        return {}
    if not edge or not edge.get("count"):
        return dict(latest)
    d_count = int(latest["count"]) - int(edge["count"])
    if d_count < 0:
        return dict(latest)
    if d_count == 0:
        return {}
    buckets = {}
    base = edge.get("buckets") or {}
    for k, n in (latest.get("buckets") or {}).items():
        d = int(n) - int(base.get(k, 0))
        if d > 0:
            buckets[k] = d
    d_sum = float(latest.get("sum") or 0.0) - float(edge.get("sum") or 0.0)
    return {
        "count": d_count,
        "sum": d_sum,
        "mean": d_sum / d_count,
        "min": latest.get("min"),
        "max": latest.get("max"),
        "buckets": buckets,
    }


def _sub_report(latest: dict, edge: dict) -> dict:
    """Windowed pseudo-report for one file: counters and histograms are
    deltas; gauges and phase totals pass through from the latest line
    (a gauge is a point-in-time reading, not a cumulative total)."""
    hists: dict = {}
    for name, series in (latest.get("histograms") or {}).items():
        base = ((edge or {}).get("histograms") or {}).get(name) or {}
        dst = {}
        for label, h in (series or {}).items():
            d = _sub_hist(h, base.get(label))
            if d:
                dst[label] = d
        if dst:
            hists[name] = dst
    return {
        "counters": _sub_counters(latest.get("counters") or {},
                                  (edge or {}).get("counters") or {}),
        "histograms": hists,
        "gauges": dict(latest.get("gauges") or {}),
    }


def _merge_reports(reports: list) -> dict:
    """Exact cross-process merge of report-shaped dicts: counters sum,
    histograms merge via ``slo.merge`` (equal-resolution exports pool
    exactly), gauges keep every per-file reading under its label."""
    counters: dict = {}
    gauges: dict = {}
    hist_names: list = []
    for rep in reports:
        for name, series in (rep.get("counters") or {}).items():
            dst = counters.setdefault(name, {})
            for label, v in (series or {}).items():
                dst[label] = dst.get(label, 0) + v
        for name in (rep.get("histograms") or {}):
            if name not in hist_names:
                hist_names.append(name)
        for name, series in (rep.get("gauges") or {}).items():
            dst = gauges.setdefault(name, {})
            for label, v in (series or {}).items():
                if label not in dst:
                    dst[label] = v
                else:  # same label from several processes: keep the max
                    dst[label] = max(dst[label], v)
    hists = {}
    for name in hist_names:
        merged = _slo_merge_series(reports, name)
        if merged:
            hists[name] = merged
    return {"counters": counters, "histograms": hists, "gauges": gauges}


class FleetView:
    """One consistent windowed/cumulative view over the fleet.

    Built by ``FleetAggregator.view()``; everything here is plain-dict
    math over already-tailed snapshots, so a view never touches the
    filesystem.  The windowed report is the merge of per-file
    bucket-deltas — by the exact-merge property this equals the report
    a single process pooling every sample in the window would export.
    """

    def __init__(self, window_report: dict, cumulative_report: dict,
                 window_s: float, now: float, files: list, health: dict):
        self.window_report = window_report
        self.cumulative_report = cumulative_report
        self.window_s = float(window_s)
        self.now = float(now)
        self.files = files
        self.health = health

    # ----------------------------------------------------- counters
    def counter(self, name, labels=None, windowed=True) -> float:
        """Summed counter value, optionally filtered by a labels dict."""
        rep = self.window_report if windowed else self.cumulative_report
        series = (rep.get("counters") or {}).get(name) or {}
        return float(sum(v for label, v in series.items()
                         if _label_match(label, labels)))

    def rate(self, name, labels=None) -> float:
        """Windowed counter increase per second."""
        return self.counter(name, labels, windowed=True) / self.window_s

    # --------------------------------------------------- histograms
    def histogram(self, name, labels=None, windowed=True) -> dict:
        """Merged histogram for ``name`` across matching label sets."""
        rep = self.window_report if windowed else self.cumulative_report
        series = (rep.get("histograms") or {}).get(name) or {}
        picked = [h for label, h in series.items()
                  if _label_match(label, labels)]
        if not picked:
            return {}
        if len(picked) == 1:
            return picked[0]
        return _slo_merge(*picked)

    def quantile(self, name, q, labels=None, windowed=True):
        """Windowed q-quantile of one latency series (None if empty)."""
        return _slo_quantile(self.histogram(name, labels, windowed), q)

    # ------------------------------------------------------- gauges
    def gauge_values(self, name) -> dict:
        """``{label: value}`` — the latest reading per label across the
        fleet (same label from several files keeps the max)."""
        return dict((self.cumulative_report.get("gauges") or {})
                    .get(name) or {})

    # --------------------------------------------------------- SLOs
    def miss_rates(self, windowed=True) -> dict:
        """Per-tenant windowed deadline-miss rates (``slo`` semantics:
        completions from the ``ensemble.e2e_s`` histogram, misses from
        the ``ensemble.deadline_miss`` counter)."""
        rep = self.window_report if windowed else self.cumulative_report
        return _slo_miss_rates(rep)


def _label_match(label_str, labels) -> bool:
    if not labels:
        return True
    have = dict(kv.split("=", 1)
                for kv in (label_str or "").split(",") if "=" in kv)
    return all(have.get(k) == str(v) for k, v in labels.items())


class FleetAggregator:
    """Tail many per-process streams; serve windowed fleet views.

    ``sources`` is a directory (``*.stream.jsonl`` discovered, new
    writers picked up on every poll), a glob, or an explicit list of
    paths.  Each poll reads only appended bytes per file and retains,
    per file, a short history of ``(ts, record)`` snapshots — just
    enough to always hold one record at or before the window edge plus
    everything after it.  ``view()`` subtracts edge from latest per
    file and merges across files.
    """

    def __init__(self, sources, window_s=None, registry=None):
        self._lock = threading.Lock()
        self._sources = sources
        self._explicit = (not isinstance(sources, (str, pathlib.Path))
                          and sources is not None)
        self.window_s = float(window_s) if window_s else default_window_s()
        self._registry = registry if registry is not None else _metrics
        self._tailers: dict = {}
        self._history: dict = {}
        self.polls = 0

    # ----------------------------------------------------- plumbing
    def _phase(self, reg):
        if reg is not None and getattr(reg, "enabled", False):
            return reg.phase("live.poll")
        import contextlib
        return contextlib.nullcontext()

    def _discover(self) -> list:
        if self._explicit:
            return [str(p) for p in self._sources]
        return discover_streams(self._sources)

    def poll(self, now=None) -> int:
        """Tail every stream; returns how many new records landed."""
        now = time.time() if now is None else float(now)
        reg = self._registry
        new = 0
        with self._phase(reg):
            paths = self._discover()
            with self._lock:
                for path in paths:
                    if path not in self._tailers:
                        self._tailers[path] = StreamTailer(path, registry=reg)
                        self._history[path] = collections.deque()
                for path, tailer in self._tailers.items():
                    recs = tailer.poll()
                    hist = self._history[path]
                    for rec in recs:
                        ts = rec.get("ts")
                        hist.append((float(ts) if ts is not None else now,
                                     rec))
                    new += len(recs)
                    self._prune(hist, now - self.window_s)
                self.polls += 1
        return new

    @staticmethod
    def _prune(hist, edge_ts) -> None:
        # keep ONE record at/before the edge (the window baseline) plus
        # everything newer; anything older can never be an edge again
        while len(hist) >= 2 and hist[1][0] <= edge_ts:
            hist.popleft()

    # -------------------------------------------------------- views
    def view(self, now=None, window_s=None) -> FleetView:
        """A consistent snapshot view over ``[now - window, now]``."""
        now = time.time() if now is None else float(now)
        window = float(window_s) if window_s else self.window_s
        edge_ts = now - window
        per_file_window: list = []
        per_file_cum: list = []
        files: list = []
        health = {"files": 0, "records": 0, "seq_gaps": 0,
                  "torn_tails": 0, "bad_lines": 0, "stale_files": 0}
        with self._lock:
            items = [(path, self._tailers[path], tuple(self._history[path]))
                     for path in self._tailers]
        for path, tailer, hist in items:
            health["files"] += 1
            health["records"] += tailer.records_read
            health["seq_gaps"] += tailer.seq_gaps
            health["torn_tails"] += tailer.torn_tails
            health["bad_lines"] += tailer.bad_lines
            if not hist:
                continue
            latest_ts, latest = hist[-1]
            edge = None
            for ts, rec in hist:
                if ts <= edge_ts:
                    edge = rec
                else:
                    break
            age = now - latest_ts
            if age > window:
                health["stale_files"] += 1
            # per-writer staleness gauge: a dead
            # writer otherwise just freezes its numbers into every
            # window — this makes the silence itself a series the
            # consoles and alert rules can watch
            reg = self._registry
            if reg is not None and getattr(reg, "enabled", False):
                reg.gauge("stream.age_s", age,
                          path=pathlib.Path(path).name)
            per_file_window.append(_sub_report(latest, edge))
            per_file_cum.append(latest)
            files.append({"path": path, "last_ts": latest_ts, "age_s": age,
                          "seq": tailer.last_seq,
                          "seq_gaps": tailer.seq_gaps,
                          "torn_tails": tailer.torn_tails,
                          "bad_lines": tailer.bad_lines})
        return FleetView(
            window_report=_merge_reports(per_file_window),
            cumulative_report=_merge_reports(per_file_cum),
            window_s=window, now=now, files=files, health=health,
        )


# ----------------------------------------------------------- exposition

def _prom_name(name: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                  for ch in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_labels(label_str: str, extra=None) -> str:
    pairs = [kv.split("=", 1)
             for kv in (label_str or "").split(",") if "=" in kv]
    if extra:
        pairs = pairs + list(extra)
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (_prom_name(k), str(v).replace("\\", "\\\\")
                     .replace('"', '\\"'))
        for k, v in pairs)
    return "{" + body + "}"


def to_prometheus(report: dict, prefix="dccrg") -> str:
    """Prometheus text exposition (v0.0.4) of one report-shaped dict.

    Counters/gauges map directly; histograms emit the standard
    cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` triple with
    ``le`` set to the registry's log-spaced upper edges (the exact
    bucket keys, so a scrape round-trips bucket-exactly)."""
    lines = []
    for name, series in sorted((report.get("counters") or {}).items()):
        full = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# HELP {full} {name}")
        lines.append(f"# TYPE {full} counter")
        for label, v in sorted(series.items()):
            lines.append(f"{full}{_prom_labels(label)} {v}")
    for name, series in sorted((report.get("gauges") or {}).items()):
        full = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# HELP {full} {name}")
        lines.append(f"# TYPE {full} gauge")
        for label, v in sorted(series.items()):
            lines.append(f"{full}{_prom_labels(label)} {v}")
    for name, series in sorted((report.get("histograms") or {}).items()):
        full = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# HELP {full} {name}")
        lines.append(f"# TYPE {full} histogram")
        for label, h in sorted(series.items()):
            edges = sorted(((float(k), k, int(n))
                            for k, n in (h.get("buckets") or {}).items()))
            cum = 0
            for _, key, n in edges:
                cum += n
                lines.append(
                    f"{full}_bucket{_prom_labels(label, [('le', key)])} "
                    f"{cum}")
            lines.append(
                f"{full}_bucket{_prom_labels(label, [('le', '+Inf')])} "
                f"{int(h.get('count') or 0)}")
            lines.append(f"{full}_sum{_prom_labels(label)} "
                         f"{float(h.get('sum') or 0.0)}")
            lines.append(f"{full}_count{_prom_labels(label)} "
                         f"{int(h.get('count') or 0)}")
    return "\n".join(lines) + "\n"


def _parse_prom_line(line: str):
    """``(name, {label: value}, float)`` for one sample line."""
    if "{" in line:
        name, rest = line.split("{", 1)
        labels_str, value_str = rest.rsplit("}", 1)
        labels = {}
        for part in _split_prom_labels(labels_str):
            if "=" not in part:
                continue
            k, v = part.split("=", 1)
            labels[k.strip()] = (v.strip().strip('"')
                                 .replace('\\"', '"').replace("\\\\", "\\"))
        return name.strip(), labels, float(value_str.strip())
    name, value_str = line.rsplit(None, 1)
    return name.strip(), {}, float(value_str)


def _split_prom_labels(s: str) -> list:
    out, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def parse_prometheus(text: str, prefix="dccrg") -> dict:
    """Inverse of ``to_prometheus``: reconstruct a report-shaped dict.

    Histogram buckets come back NON-cumulative under the original
    upper-edge keys; ``mean`` is re-derived from sum/count.  ``min`` and
    ``max`` are not part of the exposition format and so are absent."""
    types: dict = {}
    helps: dict = {}
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    strip = prefix + "_"
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 4 and parts[1] == "HELP":
                # the HELP text carries the registry's dotted series
                # name, which the sanitized exposition name cannot
                # recover on its own — the round-trip seam
                helps[parts[2]] = parts[3]
            continue
        try:
            name, labels, value = _parse_prom_line(line)
        except ValueError:
            continue
        base = name
        suffix = None
        for sfx in ("_bucket", "_sum", "_count"):
            cand = name[:-len(sfx)] if name.endswith(sfx) else None
            if cand and types.get(cand) == "histogram":
                base, suffix = cand, sfx
                break
        kind = types.get(base, "counter")
        short = helps.get(
            base, base[len(strip):] if base.startswith(strip) else base)
        if kind == "histogram":
            le = labels.pop("le", None)
            label_str = ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items()))
            h = hists.setdefault(short, {}).setdefault(
                label_str, {"count": 0, "sum": 0.0, "buckets": {}})
            if suffix == "_bucket":
                if le not in (None, "+Inf"):
                    h["buckets"][le] = int(value)
            elif suffix == "_sum":
                h["sum"] = value
            elif suffix == "_count":
                h["count"] = int(value)
        else:
            label_str = ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items()))
            dst = (gauges if kind == "gauge" else counters)
            dst.setdefault(short, {})[label_str] = value
    for series in hists.values():
        for h in series.values():
            # de-cumulate the le buckets back to per-bucket tallies
            edges = sorted((float(k), k) for k in h["buckets"])
            prev = 0
            flat = {}
            for _, key in edges:
                n = h["buckets"][key] - prev
                prev = h["buckets"][key]
                if n > 0:
                    flat[key] = n
            h["buckets"] = flat
            if h["count"]:
                h["mean"] = h["sum"] / h["count"]
    return {"counters": counters, "gauges": gauges, "histograms": hists}
