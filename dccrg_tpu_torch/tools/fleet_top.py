"""Live fleet console of the port: windowed SLOs, throughput and health
from the per-process ``*.stream.jsonl`` files a running fleet writes (the
JAX package's ``tools/fleet_top.py`` over the port's files).

Point it at the directory the serving processes stream into (or a glob,
or files) and it tails every stream from byte offsets, merges counters
and log-bucket histograms across processes (exactly: merging per-process
exports equals pooling the samples), and prints one windowed snapshot, or
refreshes with ``--follow``::

    python -m dccrg_tpu_torch.tools.fleet_top run/              # one snapshot
    python -m dccrg_tpu_torch.tools.fleet_top run/ --window 30 --follow
    python -m dccrg_tpu_torch.tools.fleet_top run/ --json -     # machine-readable
    python -m dccrg_tpu_torch.tools.fleet_top run/ --prometheus fleet.prom
    python -m dccrg_tpu_torch.tools.fleet_top run/ --alerts     # rule states too
    python -m dccrg_tpu_torch.tools.fleet_top run/ --cost       # cost and capacity
    python -m dccrg_tpu_torch.tools.fleet_top run/ --workers    # gateway fleet view

Every snapshot leads with a per-writer table with each stream's staleness
(``age_s``, seconds since its last snapshot).  ``--cost`` adds the step
cost model, the chargeback ledger with its conservation check and the
predicted queue-waits; ``--workers`` the gateway's per-worker liveness,
assignments and redispatches.

The stream, alert and cost libraries are the port's own
``obs/{live,alerts,cost}.py``; the rest is standard library.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

#: latency histograms tabulated per window (--metrics overrides)
DEFAULT_METRICS = (
    "ensemble.queue_wait_s",
    "ensemble.service_s",
    "ensemble.e2e_s",
)

#: windowed counter rates shown in the throughput block
RATE_COUNTERS = (
    "ensemble.steps_served",
    "ensemble.retired",
    "ensemble.deadline_miss",
)


def _load(name: str):
    """The port's ``obs/<name>.py`` module (``slo``, ``live``, ``alerts``
    or ``cost``)."""
    from .. import obs

    return getattr(obs, name)


def snapshot(view, metrics, qs) -> dict:
    """One JSON-ready fleet snapshot from a view."""
    latency = []
    for name in metrics:
        series = (view.window_report.get("histograms") or {}).get(name) or {}
        for label in sorted(series):
            h = series[label]
            row = {"metric": name, "labels": label,
                   "count": int(h.get("count") or 0),
                   "mean": h.get("mean")}
            for q in qs:
                row[f"p{round(q * 100):d}"] = view.quantile(
                    name, q, labels=_labels_dict(label))
            latency.append(row)
    rates = {}
    for name in RATE_COUNTERS:
        series = (view.window_report.get("counters") or {}).get(name) or {}
        if series:
            rates[name] = {label: v / view.window_s
                           for label, v in sorted(series.items())}
    return {
        "ts": view.now,
        "window_s": view.window_s,
        "health": view.health,
        "files": view.files,
        "latency": latency,
        "rates": rates,
        "deadline_miss_rates": view.miss_rates(),
        "gauges": view.cumulative_report.get("gauges") or {},
    }


def _labels_dict(label_str: str) -> dict:
    return dict(kv.split("=", 1)
                for kv in (label_str or "").split(",") if "=" in kv)


def print_snapshot(snap: dict, qs, alerts=None) -> None:
    h = snap["health"]
    print(f"fleet_top  window={snap['window_s']:.0f}s  "
          f"files={h['files']} ({h['stale_files']} stale)  "
          f"records={h['records']}  seq_gaps={h['seq_gaps']}  "
          f"torn_tails={h['torn_tails']}  bad_lines={h['bad_lines']}")
    files = snap.get("files") or []
    if files:
        print(f"{'writer':36s} {'age_s':>8s} {'seq':>8s} {'gaps':>5s} "
              f"{'torn':>5s}")
        for f in sorted(files, key=lambda f: -f["age_s"]):
            name = pathlib.Path(f["path"]).name
            seq = f.get("seq")
            print(f"{name:36s} {f['age_s']:>8.1f} "
                  f"{'n/a' if seq is None else seq:>8} "
                  f"{f['seq_gaps']:>5d} {f['torn_tails']:>5d}")
    qcols = [f"p{round(q * 100):d}" for q in qs]
    if snap["latency"]:
        head = (f"{'metric':24s} {'labels':28s} {'count':>7s} "
                + " ".join(f"{c + '(ms)':>10s}" for c in ["mean"] + qcols))
        print(head)
        print("-" * len(head))
        for r in snap["latency"]:
            cells = [r.get("mean")] + [r.get(c) for c in qcols]
            print(f"{r['metric']:24s} {r['labels']:28s} {r['count']:>7d} "
                  + " ".join("       n/a" if v is None
                             else f"{v * 1e3:>10.3f}" for v in cells))
    else:
        print("  (no latency samples in the window)")
    if snap["rates"]:
        print()
        print(f"{'counter':28s} {'labels':24s} {'rate/s':>10s}")
        for name, series in sorted(snap["rates"].items()):
            for label, r in series.items():
                print(f"{name:28s} {label:24s} {r:>10.3f}")
    miss = snap["deadline_miss_rates"]
    if miss:
        print()
        print(f"{'tenant':16s} {'completed':>9s} {'missed':>7s} {'rate':>8s}")
        for tenant, rec in sorted(miss.items()):
            rate = rec["rate"]
            print(f"{tenant:16s} {rec['completed']:>9d} "
                  f"{rec['missed']:>7d} "
                  f"{'n/a' if rate is None else f'{rate:8.2%}'}")
    if alerts is not None:
        print()
        print(f"{'alert rule':28s} {'status':8s} {'value':>12s} "
              f"{'fires':>6s}")
        for name, st in sorted(alerts.items()):
            v = st.get("value")
            print(f"{name:28s} {st['status']:8s} "
                  f"{'n/a' if v is None else f'{v:12.4g}'} "
                  f"{st['fires']:>6d}")
    if snap.get("workers") is not None:
        print_workers(snap["workers"])
    if snap.get("cost") is not None:
        print_cost(snap["cost"])


def workers_section(view) -> dict:
    """The ``--workers`` snapshot section: per-worker
    liveness from each ``worker.stream.jsonl`` heartbeat's staleness
    (the same ``stream.age_s`` signal the shipped ``worker-lost``
    alert rule fires on), assigned/in-flight counts from the gateway's
    ``gateway.assigned{worker}`` gauges, and redispatch events from
    the ``gateway.redispatched{worker}`` counter."""
    import os

    try:
        stall = float(os.environ.get("DCCRG_GATEWAY_STALL_S", "10"))
    except ValueError:
        stall = 10.0
    cum = view.cumulative_report
    gauges = cum.get("gauges") or {}
    counters = cum.get("counters") or {}
    workers: dict = {}

    def row(wid: str) -> dict:
        return workers.setdefault(wid, {
            "age_s": None, "alive": None, "seq": None, "torn": 0,
            "assigned": 0, "redispatched_from": 0})

    for f in view.files:
        p = pathlib.Path(f["path"])
        if "worker" not in p.name:
            continue
        r = row(p.parent.name or p.stem)
        r["age_s"] = f["age_s"]
        r["alive"] = f["age_s"] <= stall
        r["seq"] = f.get("seq")
        r["torn"] = f.get("torn_tails", 0)
    for label, v in (gauges.get("gateway.assigned") or {}).items():
        wid = _labels_dict(label).get("worker")
        if wid:
            row(wid)["assigned"] = int(v)
    for label, v in (counters.get("gateway.redispatched") or {}).items():
        wid = _labels_dict(label).get("worker")
        if wid:
            row(wid)["redispatched_from"] = int(v)
    return {
        "workers": workers,
        "redispatch_total": int(sum(
            (counters.get("gateway.redispatched") or {}).values())),
        "worker_lost_total": int(sum(
            (counters.get("gateway.worker_lost") or {}).values())),
        "backlog": (gauges.get("gateway.backlog") or {}).get("", None),
    }


def print_workers(w: dict) -> None:
    print()
    print(f"workers  redispatches={w['redispatch_total']}  "
          f"lost={w['worker_lost_total']}  "
          f"backlog={'n/a' if w.get('backlog') is None else w['backlog']}")
    rows = w.get("workers") or {}
    if not rows:
        print("  (no worker streams found)")
        return
    print(f"{'worker':16s} {'live':>5s} {'age_s':>8s} {'seq':>8s} "
          f"{'assigned':>9s} {'redisp_from':>12s}")
    for wid, r in sorted(rows.items()):
        age = r.get("age_s")
        alive = r.get("alive")
        print(f"{wid:16s} "
              f"{'n/a' if alive is None else ('yes' if alive else 'NO'):>5s} "
              f"{'n/a' if age is None else f'{age:8.1f}':>8s} "
              f"{'n/a' if r.get('seq') is None else r['seq']:>8} "
              f"{r['assigned']:>9d} {r['redispatched_from']:>12d}")


def cost_section(view, cost_mod) -> dict:
    """The ``--cost`` snapshot section: the fleet cost model and
    ledger from the cumulative merge, plus windowed read-side
    queue-wait estimates (bucket-delta service rates)."""
    out = cost_mod.cost_summary(view.cumulative_report)
    out["queue_wait_estimates"] = cost_mod.queue_wait_estimates(view)
    return out


def print_cost(cost: dict) -> None:
    rows = cost.get("model") or []
    print()
    if rows:
        print(f"{'cost model key':44s} {'n':>6s} {'mean(ms)':>9s} "
              f"{'p50(ms)':>9s} {'p95(ms)':>9s}")
        for r in rows:
            print(f"{r['key']:44s} {r['n']:>6d} "
                  f"{r['mean_s'] * 1e3:>9.3f} "
                  f"{r.get('p50_s', 0.0) * 1e3:>9.3f} "
                  f"{r.get('p95_s', 0.0) * 1e3:>9.3f}")
    else:
        print("  (no cost-model samples)")
    ledger = cost.get("chargeback") or {}
    if ledger:
        print()
        print(f"{'tenant':16s} {'device_s':>10s} {'share':>7s} "
              f"{'steps':>8s} {'halo_ex':>9s} {'compile_s':>9s}")
        for tenant, rec in sorted(ledger.items()):
            print(f"{tenant:16s} {rec['device_s']:>10.3f} "
                  f"{rec['device_share']:>7.2%} "
                  f"{rec['member_steps']:>8d} "
                  f"{rec['halo_exchanges']:>9.0f} "
                  f"{rec['compile_s']:>9.3f}")
        cons = cost.get("conservation") or {}
        ratio = cons.get("ratio")
        print(f"conservation: attributed={cons.get('attributed', 0.0):.3f}s "
              f"total={cons.get('total', 0.0):.3f}s "
              f"ratio={'n/a' if ratio is None else f'{ratio:.4f}'} "
              f"{'OK' if cons.get('ok') else 'VIOLATED'}")
    waits = {**(cost.get("predicted_queue_wait_s") or {}),
             **(cost.get("queue_wait_estimates") or {})}
    if waits:
        print()
        print(f"{'tenant':16s} {'predicted_wait_s':>16s}")
        for tenant, w in sorted(waits.items()):
            print(f"{tenant:16s} {w:>16.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("sources", nargs="*", default=["."],
                    help="stream dir(s), glob(s) or *.stream.jsonl files")
    ap.add_argument("--window", type=float, default=None,
                    help="sliding window seconds "
                         "(default DCCRG_LIVE_WINDOW_S or 60)")
    ap.add_argument("--metrics", default=",".join(DEFAULT_METRICS),
                    help="comma-separated histogram names to tabulate")
    ap.add_argument("--quantiles", default="0.5,0.95,0.99",
                    help="comma-separated quantile fractions")
    ap.add_argument("--json", default=None,
                    help="write the snapshot JSON to this path ('-' "
                         "for stdout, replacing the console view)")
    ap.add_argument("--prometheus", default=None,
                    help="write a Prometheus text exposition of the "
                         "windowed report to this path ('-' for stdout)")
    ap.add_argument("--alerts", action="store_true",
                    help="evaluate the alert rules (DCCRG_ALERT_RULES "
                         "or the shipped defaults) against each view")
    ap.add_argument("--cost", action="store_true",
                    help="add the cost & capacity section: step-cost "
                         "model, chargeback ledger + conservation, "
                         "predicted queue-waits")
    ap.add_argument("--workers", action="store_true",
                    help="add the gateway fleet section: per-worker "
                         "liveness (heartbeat staleness), assigned "
                         "counts and redispatch events")
    ap.add_argument("--follow", action="store_true",
                    help="refresh in place every --refresh seconds")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="refresh period for --follow")
    ap.add_argument("--iterations", type=int, default=0,
                    help="with --follow: stop after N refreshes "
                         "(0 = until interrupted)")
    args = ap.parse_args(argv)

    live = _load("live")
    qs = tuple(float(x) for x in args.quantiles.split(",") if x)
    metrics = [m for m in args.metrics.split(",") if m]
    paths: list = []
    for src in args.sources:
        paths.extend(live.discover_streams(src))
    if not paths and not args.follow:
        print("fleet_top: no *.stream.jsonl sources found",
              file=sys.stderr)
        return 2
    # a single directory source keeps discovering new writers per poll
    sources = (args.sources[0]
               if len(args.sources) == 1 and not paths else paths)
    agg = live.FleetAggregator(sources, window_s=args.window)
    cost_mod = _load("cost") if args.cost else None
    engine = None
    if args.alerts:
        alerts_mod = _load("alerts")
        if alerts_mod.alerts_enabled():
            engine = alerts_mod.AlertEngine(alerts_mod.rules_from_env())

    n = 0
    while True:
        agg.poll()
        view = agg.view()
        alert_states = None
        if engine is not None:
            engine.poll(view)
            alert_states = engine.snapshot()
        snap = snapshot(view, metrics, qs)
        if alert_states is not None:
            snap["alerts"] = alert_states
        if cost_mod is not None:
            snap["cost"] = cost_section(view, cost_mod)
        if args.workers:
            snap["workers"] = workers_section(view)
        if args.prometheus:
            text = live.to_prometheus(view.window_report)
            if args.prometheus == "-":
                sys.stdout.write(text)
            else:
                with open(args.prometheus, "w") as f:
                    f.write(text)
        if args.json:
            text = json.dumps(snap, indent=1, default=float)
            if args.json == "-":
                print(text)
            else:
                with open(args.json, "w") as f:
                    f.write(text)
        elif not (args.prometheus == "-"):
            if args.follow and n:
                print()
            print_snapshot(snap, qs, alerts=alert_states)
        n += 1
        if not args.follow or (args.iterations and n >= args.iterations):
            break
        try:
            time.sleep(max(args.refresh, 0.1))
        except KeyboardInterrupt:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
