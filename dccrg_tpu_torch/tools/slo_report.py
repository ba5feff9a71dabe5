"""Request-level SLO report of the port: latency quantiles,
deadline-miss rates and a slowest-request drill-down from exported
telemetry alone (the JAX package's ``tools/slo_report.py`` over the
port's files).

No live process is needed: the inputs are the files the serving stack
leaves behind: ``telemetry.json`` snapshots, streaming ``*.jsonl``
heartbeats (the last complete line wins), bench records.  Several sources
merge (``obs/slo.py``: log-bucket histograms add exactly), so per-tenant
p50/p95/p99 aggregate across processes as one process would have
recorded them:

    python -m dccrg_tpu_torch.tools.slo_report            # _telemetry/telemetry.json
    python -m dccrg_tpu_torch.tools.slo_report run1.json run2.json
    python -m dccrg_tpu_torch.tools.slo_report --json slo.json

``--trace`` takes a Chrome or merged trace (``obs.merge_profile`` output,
or any ``export_chrome_trace`` file whose timeline recorded
``request.e2e`` spans) and prints the N slowest requests with the device
spans that overlap each one's window.  ``--live DIR`` reports the windowed
view of the ``*.stream.jsonl`` files under DIR instead.

The quantile and stream libraries are the port's own ``obs/slo.py`` and
``obs/live.py``; the rest is standard library.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import DEFAULT_TELEMETRY

#: histogram names tabulated by default (--metrics overrides); the
#: phase-duration series is opt-in via --metrics phase.duration_s
DEFAULT_METRICS = (
    "ensemble.queue_wait_s",
    "ensemble.service_s",
    "ensemble.e2e_s",
)


def load_slo():
    """The quantile/merge library (``obs/slo.py``)."""
    from ..obs import slo

    return slo


def load_live():
    """The live aggregator (``obs/live.py``)."""
    from ..obs import live

    return live


def combine_reports(slo, reports: list, metrics) -> dict:
    """One merged pseudo-report: histograms merged per (name, label),
    counters summed per (name, label) — each input report is one
    process/round's cumulative state, so summing across inputs is the
    fleet total."""
    hists = {name: slo.merge_series(reports, name) for name in metrics}
    counters: dict = {}
    for rep in reports:
        for name, series in (rep.get("counters") or {}).items():
            dst = counters.setdefault(name, {})
            for label, v in series.items():
                dst[label] = dst.get(label, 0) + v
    return {
        "histograms": {n: s for n, s in hists.items() if s},
        "counters": counters,
    }


def quantile_table(slo, combined: dict, qs) -> list:
    """Rows of ``{metric, labels, count, mean, pXX...}`` (seconds)."""
    rows = []
    for name, series in sorted(combined["histograms"].items()):
        for label, h in sorted(series.items()):
            rows.append({
                "metric": name,
                "labels": label,
                **slo.summarize(h, qs),
            })
    return rows


def print_tables(rows: list, miss_rates: dict, qs) -> None:
    qcols = [f"p{round(q * 100):d}" for q in qs]
    if rows:
        head = (f"{'metric':24s} {'labels':28s} {'count':>7s} "
                + " ".join(f"{c + '(ms)':>10s}" for c in ["mean"] + qcols))
        print(head)
        print("-" * len(head))
        for r in rows:
            cells = [r.get("mean")] + [r.get(c) for c in qcols]
            print(f"{r['metric']:24s} {r['labels']:28s} "
                  f"{r.get('count', 0):>7d} "
                  + " ".join("       n/a" if v is None
                             else f"{v * 1e3:>10.3f}" for v in cells))
    else:
        print("no latency histograms found in the given sources")
    if miss_rates:
        print()
        print(f"{'tenant':16s} {'completed':>9s} {'deadline miss':>13s} "
              f"{'rate':>8s}")
        for tenant, rec in sorted(miss_rates.items()):
            rate = rec["rate"]
            print(f"{tenant:16s} {rec['completed']:>9d} "
                  f"{rec['missed']:>13d} "
                  f"{'n/a' if rate is None else f'{rate:8.2%}'}")


# --------------------------------------------------------- drill-down

def _trace_spans(events: list) -> list:
    """Reconstruct ``{name, pid, tid, ts, dur, args}`` spans (µs) from a
    Chrome trace-event list: X events directly, B/E pairs per thread."""
    spans = []
    stacks: dict = {}
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            spans.append({"name": ev.get("name"), "pid": ev.get("pid"),
                          "tid": ev.get("tid"), "ts": ev.get("ts", 0.0),
                          "dur": ev.get("dur", 0.0),
                          "args": ev.get("args") or {}})
        elif ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if stack:
                b = stack.pop()
                spans.append({
                    "name": b.get("name"), "pid": b.get("pid"),
                    "tid": b.get("tid"), "ts": b.get("ts", 0.0),
                    "dur": max(ev.get("ts", 0.0) - b.get("ts", 0.0), 0.0),
                    "args": b.get("args") or {},
                })
    return spans


def slowest_requests(trace: dict, top: int = 5,
                     kernels_per_request: int = 6) -> list:
    """The ``top`` slowest ``request.e2e`` spans in a (merged) trace,
    each cross-referenced with the longest spans from OTHER pids —
    device kernel tracks in a merged trace — overlapping its window."""
    events = trace.get("traceEvents") if isinstance(trace, dict) else trace
    spans = _trace_spans(events or [])
    requests = sorted(
        (s for s in spans if s["name"] == "request.e2e"),
        key=lambda s: -s["dur"],
    )[:max(top, 0)]
    out = []
    for rq in requests:
        lo, hi = rq["ts"], rq["ts"] + rq["dur"]
        overlapping = [
            s for s in spans
            if s["pid"] != rq["pid"]
            and s["ts"] < hi and s["ts"] + s["dur"] > lo
        ]
        overlapping.sort(key=lambda s: -s["dur"])
        out.append({
            "request": (rq["args"] or {}).get("request"),
            "tenant": (rq["args"] or {}).get("tenant"),
            "e2e_ms": round(rq["dur"] / 1e3, 3),
            "deadline_missed": (rq["args"] or {}).get("deadline_missed"),
            "window_us": [round(lo, 1), round(hi, 1)],
            "kernels": [
                {"name": s["name"], "pid": s["pid"],
                 "dur_ms": round(s["dur"] / 1e3, 3)}
                for s in overlapping[:kernels_per_request]
            ],
        })
    return out


def print_drilldown(slow: list) -> None:
    if not slow:
        print("drill-down: no request.e2e spans in the trace")
        return
    print()
    print("slowest requests (cross-referenced to overlapping "
          "device/kernel spans):")
    for rec in slow:
        missed = " DEADLINE-MISSED" if rec.get("deadline_missed") else ""
        print(f"  request={rec['request']} tenant={rec['tenant']} "
              f"e2e={rec['e2e_ms']:.3f}ms{missed}")
        for k in rec["kernels"]:
            print(f"    {k['dur_ms']:>10.3f}ms  pid={k['pid']:<6} "
                  f"{k['name']}")
        if not rec["kernels"]:
            print("    (no overlapping spans from other tracks)")


def live_report(slo, args, metrics, qs) -> int:
    """``--live``: windowed per-tenant tables from stream dirs via the
    aggregator; ``--follow`` re-polls and reprints every refresh."""
    import time

    live = load_live()
    agg = live.FleetAggregator(args.live, window_s=args.window)
    rounds = 0
    while True:
        agg.poll()
        view = agg.view()
        combined = {
            "histograms": {
                name: series for name, series in
                (view.window_report.get("histograms") or {}).items()
                if name in metrics
            },
            "counters": view.window_report.get("counters") or {},
        }
        if rounds:
            print()
        h = view.health
        print(f"live window={view.window_s:.0f}s  files={h['files']} "
              f"({h['stale_files']} stale)  records={h['records']}  "
              f"seq_gaps={h['seq_gaps']}  torn_tails={h['torn_tails']}")
        rows = quantile_table(slo, combined, qs)
        miss_rates = slo.deadline_miss_rates(combined)
        print_tables(rows, miss_rates, qs)
        if args.json:
            report = {
                "live": args.live,
                "window_s": view.window_s,
                "health": h,
                "quantiles": list(qs),
                "latency": rows,
                "deadline_miss_rates": miss_rates,
            }
            tmp = args.json + ".tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1, default=float)
            os.replace(tmp, args.json)
        rounds += 1
        if not args.follow:
            break
        try:
            time.sleep(max(args.refresh, 0.1))
        except KeyboardInterrupt:
            break
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("sources", nargs="*",
                    default=[str(DEFAULT_TELEMETRY)],
                    help="telemetry.json / *.jsonl stream / bench "
                         "record files; histograms merge across them")
    ap.add_argument("--metrics", default=",".join(DEFAULT_METRICS),
                    help="comma-separated histogram names to tabulate")
    ap.add_argument("--quantiles", default="0.5,0.95,0.99",
                    help="comma-separated quantile fractions")
    ap.add_argument("--trace", default=None,
                    help="Chrome/merged trace for the slowest-request "
                         "kernel drill-down")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest requests to drill into")
    ap.add_argument("--json", default=None,
                    help="also write the full report object to this path")
    ap.add_argument("--live", default=None, metavar="DIR",
                    help="tail *.stream.jsonl files under DIR via the "
                         "live aggregator and report the WINDOWED "
                         "per-tenant view instead of final exports")
    ap.add_argument("--window", type=float, default=None,
                    help="with --live: sliding window seconds "
                         "(default DCCRG_LIVE_WINDOW_S or 60)")
    ap.add_argument("--follow", action="store_true",
                    help="with --live: refresh the tables every "
                         "--refresh seconds until interrupted")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="refresh period for --follow")
    args = ap.parse_args(argv)

    slo = load_slo()
    qs = tuple(float(x) for x in args.quantiles.split(",") if x)
    metrics = [m for m in args.metrics.split(",") if m]

    if args.live:
        return live_report(slo, args, metrics, qs)

    reports = []
    for src in args.sources:
        try:
            reports.append(slo.load_report(src))
        except (OSError, ValueError) as e:
            print(f"slo_report: skipping {src}: {e}", file=sys.stderr)
    if not reports:
        print("slo_report: no readable telemetry sources", file=sys.stderr)
        return 2
    combined = combine_reports(slo, reports, metrics)
    rows = quantile_table(slo, combined, qs)
    miss_rates = slo.deadline_miss_rates(combined)
    print_tables(rows, miss_rates, qs)

    slow = None
    if args.trace:
        try:
            with open(args.trace) as f:
                trace = json.load(f)
            slow = slowest_requests(trace, top=args.top)
            print_drilldown(slow)
        except (OSError, ValueError) as e:
            print(f"slo_report: trace unreadable: {e}", file=sys.stderr)

    if args.json:
        report = {
            "sources": list(args.sources),
            "quantiles": list(qs),
            "latency": rows,
            "deadline_miss_rates": miss_rates,
            **({"slowest_requests": slow} if slow is not None else {}),
        }
        tmp = args.json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=float)
        os.replace(tmp, args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
