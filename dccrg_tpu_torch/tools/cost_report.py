"""Fleet cost and capacity console of the port: step-cost model tables,
per-tenant chargeback and predicted queue-waits from exported telemetry
alone (the JAX package's ``tools/cost_report.py`` over the port's files).

The inputs are the files the serving stack leaves behind:
``telemetry.json`` snapshots, streaming ``*.jsonl`` heartbeats (the last
complete line wins), bench records.  The cost series merge exactly across
sources (``obs/cost.py`` on the log-bucket histogram and summed-counter
algebra of ``obs/slo.py``):

    python -m dccrg_tpu_torch.tools.cost_report             # _telemetry/telemetry.json
    python -m dccrg_tpu_torch.tools.cost_report run1.json run2.json
    python -m dccrg_tpu_torch.tools.cost_report --json cost.json
    python -m dccrg_tpu_torch.tools.cost_report --live run/ --follow

Sections: the step-cost model (one row a ``(model, sig, k, g, w)`` body
key: samples, mean and std, p50/p95 seconds an interior step), the
chargeback ledger (device-seconds and share, member-steps, attributed
halo exchanges and compile time) with its conservation check, and the
capacity view (the ``cost.predicted_queue_wait_s{tenant}`` gauges; with
``--live`` also the read-side estimates from the windowed service rates).

The cost, quantile and stream libraries are the port's own
``obs/{cost,slo,live}.py``; the rest is standard library.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import DEFAULT_TELEMETRY


def _load(name: str):
    """The port's ``obs/<name>.py`` module (``slo``, ``live``, ``alerts``
    or ``cost``)."""
    from .. import obs

    return getattr(obs, name)


def print_report(summary: dict) -> None:
    rows = summary.get("model") or []
    if rows:
        print(f"{'cost model key':46s} {'n':>6s} {'mean(ms)':>9s} "
              f"{'std(ms)':>9s} {'p50(ms)':>9s} {'p95(ms)':>9s}")
        for r in rows:
            print(f"{r['key']:46s} {r['n']:>6d} "
                  f"{r['mean_s'] * 1e3:>9.3f} {r['std_s'] * 1e3:>9.3f} "
                  f"{r.get('p50_s', 0.0) * 1e3:>9.3f} "
                  f"{r.get('p95_s', 0.0) * 1e3:>9.3f}")
    else:
        print("no cost-model samples found in the given sources")
    ledger = summary.get("chargeback") or {}
    if ledger:
        print()
        print(f"{'tenant':16s} {'device_s':>10s} {'share':>7s} "
              f"{'steps':>9s} {'halo_ex':>9s} {'compile_s':>9s} "
              f"{'recompiles':>10s}")
        for tenant, rec in sorted(ledger.items()):
            print(f"{tenant:16s} {rec['device_s']:>10.3f} "
                  f"{rec['device_share']:>7.2%} "
                  f"{rec['member_steps']:>9d} "
                  f"{rec['halo_exchanges']:>9.0f} "
                  f"{rec['compile_s']:>9.3f} "
                  f"{rec['recompiles']:>10.1f}")
        cons = summary.get("conservation") or {}
        ratio = cons.get("ratio")
        print(f"conservation: attributed="
              f"{cons.get('attributed', 0.0):.3f}s "
              f"total={cons.get('total', 0.0):.3f}s "
              f"ratio={'n/a' if ratio is None else f'{ratio:.4f}'} "
              f"{'OK' if cons.get('ok') else 'VIOLATED'}")
    waits = {**(summary.get("predicted_queue_wait_s") or {}),
             **(summary.get("queue_wait_estimates") or {})}
    if waits:
        print()
        print(f"{'tenant':16s} {'predicted_wait_s':>16s}")
        for tenant, w in sorted(waits.items()):
            print(f"{tenant:16s} {w:>16.3f}")


def _write_json(summary: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    os.replace(tmp, path)


def live_report(cost, args) -> int:
    """``--live``: windowed cost & capacity view from stream dirs via
    the fleet aggregator; ``--follow`` re-polls every refresh."""
    import time

    live = _load("live")
    agg = live.FleetAggregator(args.live, window_s=args.window)
    rounds = 0
    while True:
        agg.poll()
        view = agg.view()
        summary = cost.cost_summary(view.cumulative_report)
        summary["queue_wait_estimates"] = cost.queue_wait_estimates(view)
        if rounds:
            print()
        h = view.health
        print(f"cost live window={view.window_s:.0f}s  "
              f"files={h['files']} ({h['stale_files']} stale)  "
              f"records={h['records']}")
        print_report(summary)
        if args.json:
            _write_json(summary, args.json)
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
                         "record files; cost series merge across them")
    ap.add_argument("--json", default=None,
                    help="also write the summary object to this path")
    ap.add_argument("--live", default=None, metavar="DIR",
                    help="tail *.stream.jsonl files under DIR via the "
                         "live aggregator: fleet model from the "
                         "cumulative merge plus windowed queue-wait "
                         "estimates")
    ap.add_argument("--window", type=float, default=None,
                    help="with --live: sliding window seconds "
                         "(default DCCRG_LIVE_WINDOW_S or 60)")
    ap.add_argument("--follow", action="store_true",
                    help="with --live: refresh every --refresh seconds")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="refresh period for --follow")
    args = ap.parse_args(argv)

    cost = _load("cost")
    if args.live:
        return live_report(cost, args)

    slo = _load("slo")
    reports = []
    for src in args.sources:
        try:
            reports.append(slo.load_report(src))
        except (OSError, ValueError) as e:
            print(f"cost_report: skipping {src}: {e}", file=sys.stderr)
    if not reports:
        print("cost_report: no readable telemetry sources",
              file=sys.stderr)
        return 2
    summary = cost.cost_summary(reports)
    print_report(summary)
    if args.json:
        _write_json(summary, args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
