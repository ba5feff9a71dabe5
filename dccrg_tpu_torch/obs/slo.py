"""Request-level SLO primitives: mergeable log-bucketed latency
histograms with post-hoc quantile estimation.

The registry's histograms (``obs/registry.py``) export as plain dicts —
``{"count", "sum", "mean", "min", "max", "buckets": {upper_edge: n}}``
with log-spaced bucket edges (power-of-two by default, finer where a
series registered a higher resolution via
``MetricsRegistry.set_histogram_resolution``).  This module is the
read side: everything here operates on that EXPORTED form, so latency
distributions survive a SIGKILL (the streaming JSONL carries them line
by line), merge across soak/ensemble children, and answer "what was
p99" long after the process is gone:

* :func:`quantile` — log-interpolated quantile estimate from the bucket
  counts, clamped into the recorded ``[min, max]`` envelope (a
  single-valued series reproduces its value exactly, any estimate is
  bounded by one bucket's width);
* :func:`merge` — histogram union: counts and bucket tallies add,
  min/max extend.  Merging two registries' exports is EXACT: it equals
  observing the pooled samples into one registry, because equal values
  land in equal buckets (same edge computation both sides);
* :func:`merge_series` / :func:`collect_series` — the same across whole
  report snapshots (``telemetry.json`` files, stream lines), per label;
* :func:`summarize` — one ``{count, mean, p50, p95, p99, ...}`` row,
  the shape ``tools/slo_report.py`` tabulates;
* :func:`deadline_miss_rates` — per-tenant miss accounting from the
  ``ensemble.deadline_miss{tenant}`` counters against completions
  (the per-tenant ``ensemble.e2e_s`` histogram counts);
* :func:`load_report` — read any telemetry-bearing file shape this repo
  produces (``telemetry.json``, a streaming ``*.jsonl`` — last complete
  line wins — or a ``BENCH_DETAIL.json`` record).

Module-level imports are stdlib-only.  A copy of the JAX package's
``obs/slo.py``: the consoles that load that copy read the port's exports,
whose format is the same.
"""
from __future__ import annotations

import json
import pathlib

__all__ = [
    "SLO_RESOLUTION",
    "quantile",
    "quantiles",
    "merge",
    "collect_series",
    "merge_series",
    "summarize",
    "deadline_miss_rates",
    "load_report",
]

#: buckets per octave the SLO latency series register (9% edge spacing:
#: a quantile estimate is off by at most one bucket, so well under the
#: telemetry_diff ceiling threshold)
SLO_RESOLUTION = 8

#: the request-latency histograms the serving front-end records — the
#: series the report CLI tabulates and the diff gate ceilings by default
LATENCY_HISTOGRAMS = (
    "ensemble.queue_wait_s",
    "ensemble.service_s",
    "ensemble.e2e_s",
)


def quantile(hist: dict, q: float):
    """Estimate the ``q``-quantile of one exported histogram dict.

    Buckets are ``(previous_edge, edge]``; the estimate interpolates
    geometrically inside the covering bucket (log-spaced edges make
    that the natural interpolant) and is clamped into the recorded
    ``[min, max]`` envelope.  Returns None for an empty histogram."""
    if not hist:
        return None
    count = int(hist.get("count") or 0)
    if count <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    mn, mx = hist.get("min"), hist.get("max")
    items = sorted(
        (float(k), int(n))
        for k, n in (hist.get("buckets") or {}).items()
    )
    if not items:
        # pre-bucket exports: the range is the only evidence
        if mn is None or mx is None:
            return None
        return mn + q * (mx - mn)
    rank = q * count
    cum = 0
    prev_edge = None
    val = mx
    for edge, n in items:
        if n > 0 and cum + n >= rank:
            if edge <= 0.0:
                # the non-positive bucket: its samples are <= 0
                val = mn if mn is not None else 0.0
            else:
                # log buckets are at most one octave wide, so the lower
                # edge is bounded below by edge/2 even when intermediate
                # empty buckets were never materialized
                lo = edge / 2.0
                if prev_edge is not None and prev_edge > lo:
                    lo = prev_edge
                f = (rank - cum) / n if n else 1.0
                val = lo * (edge / lo) ** f
            break
        cum += n
        prev_edge = edge
    if mn is not None and val is not None:
        val = max(val, mn)
    if mx is not None and val is not None:
        val = min(val, mx)
    return val


def quantiles(hist: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` for the given fractions."""
    return {f"p{round(q * 100):d}": quantile(hist, q) for q in qs}


def merge(*hists) -> dict:
    """Union of exported histograms: counts/sums/bucket tallies add,
    min/max extend.  None/empty inputs are skipped; merging exports
    from registries that registered the SAME resolution for the series
    is exact (equal samples produce equal bucket keys)."""
    out = {"count": 0, "sum": 0.0, "min": None, "max": None, "buckets": {}}
    for h in hists:
        if not h or not h.get("count"):
            continue
        out["count"] += int(h["count"])
        out["sum"] += float(h.get("sum") or 0.0)
        for bound, pick in (("min", min), ("max", max)):
            v = h.get(bound)
            if v is not None:
                out[bound] = v if out[bound] is None else pick(out[bound], v)
        for k, n in (h.get("buckets") or {}).items():
            out["buckets"][k] = out["buckets"].get(k, 0) + int(n)
    out["mean"] = out["sum"] / max(out["count"], 1)
    out["buckets"] = dict(
        sorted(out["buckets"].items(), key=lambda kv: float(kv[0]))
    )
    return out


def collect_series(report: dict, name: str) -> dict:
    """``{label_string: hist}`` for one histogram name out of a report
    snapshot (``registry.report()`` / ``telemetry.json`` shape)."""
    return dict((report.get("histograms") or {}).get(name) or {})


def merge_series(reports, name: str) -> dict:
    """Merge one histogram name across report snapshots, label by
    label: ``{label_string: merged_hist}``.  The cross-process form —
    hand it the parsed ``telemetry.json`` / stream-line dicts of every
    child and each labeled series aggregates as if one process had
    observed everything."""
    out: dict = {}
    for rep in reports:
        for label, h in collect_series(rep, name).items():
            out[label] = merge(out[label], h) if label in out else merge(h)
    return out


def summarize(hist: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    """One table row: count/mean/min/max plus the requested quantiles."""
    if not hist or not hist.get("count"):
        return {"count": 0}
    return {
        "count": int(hist["count"]),
        "mean": hist.get("mean", hist.get("sum", 0.0) / hist["count"]),
        "min": hist.get("min"),
        "max": hist.get("max"),
        **quantiles(hist, qs),
    }


def deadline_miss_rates(report: dict) -> dict:
    """Per-tenant deadline accounting from one report snapshot:
    ``{tenant: {"missed", "completed", "rate"}}``.  Completions are the
    per-tenant ``ensemble.e2e_s`` histogram counts (every retirement
    records exactly one e2e sample), misses the
    ``ensemble.deadline_miss{tenant}`` counter."""
    completed: dict = {}
    for label, h in collect_series(report, "ensemble.e2e_s").items():
        tenant = dict(
            kv.split("=", 1) for kv in label.split(",") if "=" in kv
        ).get("tenant", label or "default")
        completed[tenant] = completed.get(tenant, 0) + int(h.get("count", 0))
    missed: dict = {}
    series = (report.get("counters") or {}).get("ensemble.deadline_miss", {})
    for label, v in series.items():
        tenant = dict(
            kv.split("=", 1) for kv in label.split(",") if "=" in kv
        ).get("tenant", label or "default")
        missed[tenant] = missed.get(tenant, 0) + int(v)
    out = {}
    for tenant in sorted(set(completed) | set(missed)):
        c = completed.get(tenant, 0)
        m = missed.get(tenant, 0)
        out[tenant] = {
            "missed": m,
            "completed": c,
            "rate": (m / c) if c else None,
        }
    return out


def load_report(path: str) -> dict:
    """Parse any telemetry-bearing file this repo writes into one report
    dict carrying ``histograms``/``counters``: ``telemetry.json``, a
    streaming ``*.jsonl`` (the LAST complete line with histograms wins —
    counters and histograms are cumulative), or a bench record with
    ``detail.telemetry``.  Raises ValueError when no histogram table is
    found."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix == ".jsonl" or "\n{" in text.strip():
        last = None
        for ln in text.splitlines():
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue  # killed mid-write: earlier complete lines count
            if isinstance(rec, dict) and "histograms" in rec:
                last = rec
        if last is None:
            raise ValueError(f"{path}: no snapshot line carries "
                             "'histograms'")
        return last
    data = json.loads(text)
    if "histograms" in data:
        return data
    tel = (data.get("detail") or {}).get("telemetry") or {}
    if "histograms" in tel:
        return tel
    raise ValueError(f"{path}: no histogram table found (not "
                     "telemetry.json, a bench record, or a telemetry "
                     "JSONL stream)")
