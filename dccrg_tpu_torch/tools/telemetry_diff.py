"""Perf-regression gate of the port: diff two rounds' telemetry phase
breakdowns (the JAX package's ``tools/telemetry_diff.py`` over the port's
files).

Compares the current round's phase timings (``telemetry.json``, a bench
record, or a streaming JSONL snapshot, whose last line wins) against a
baseline of the same shapes and fails (exit 1) when any gated phase's mean
time regresses by more than ``--threshold`` (fractional: 0.35 = +35%).
Phases named by ``--allow`` are reported but never fail the gate.  The
counter, gauge floor and ceiling and p99 ceiling gates ride along, as in
the JAX tool.

    python -m dccrg_tpu_torch.tools.telemetry_diff --current NEW.json \
        --baseline OLD.json --threshold 0.5 --allow amr.refine --json v.json

Defaults are the port gate's files: ``--current`` is
``_telemetry/telemetry.json``; with ``--baseline`` omitted the baseline is
``telemetry_prev.json`` beside ``--current`` (none: a vacuous PASS); the
history is ``telemetry_history.jsonl`` beside ``--current``.  The root
``telemetry.json`` and ``tools/telemetry*`` are the JAX gate's and are
neither read nor written unless named.

Mean per completed span (``total_s / count``) is compared, not totals.
Phases whose baseline total is below ``--min-total`` are skipped as
noise.  A phase in the baseline but missing from the current round is a
coverage loss and fails (unless allowed); new phases only inform.  Every
run appends its phase table to the history (the last ``--history-keep``
rounds) and gates the current round against the oldest retained one with
``--drift-threshold``; ``--no-history`` disables both.

The quantile library is the port's own ``obs/slo.py``; the rest is
standard library.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

from . import DEFAULT_TELEMETRY

#: the hot-seam phases the gate watches by default (halo / epoch / the
#: in-loop step seams, plus the incremental rebuild); --phases
#: overrides
DEFAULT_PHASES = (
    "halo.exchange",
    # the split-phase dispatch seam — the in-flight window the
    # overlap gauge measures is opened here, and its dispatch cost is a
    # hot-path regression like the blocking exchange's
    "halo.start",
    "epoch.build",
    "epoch.hood_build",
    "epoch.delta_build",
    "loadbalance.migrate",
    "amr.refine",
    "checkpoint.write",
    "checkpoint.read",
    # time spent (re)tracing kernels — a round whose compile
    # mean balloons lost shape stability somewhere
    "compile",
)

#: counters gated round-over-round (total across labels): a probe round
#: that compiles more kernels than the previous round regressed the
#: shape-stable-epoch contract even if each compile stayed cheap
GATED_COUNTERS = (
    "epoch.recompiles",
    # the model-driven select_k slack clamp prices dispatch
    # width from pooled step-cost quantiles instead of the cohort EMA —
    # the one regression that pricing change could introduce is MISSING
    # MORE DEADLINES.  The probe workload pins the count (the SLO probe
    # produces exactly its scripted misses; the cost probe submits no
    # deadlines), so any rise here is the clamp mispricing, not noise.
    "ensemble.deadline_miss",
    # the fleet probe scripts its gateway workload exactly —
    # 4 accepted scenarios, 1 pinned-queue rejection, one forced worker
    # kill whose in-flight set redispatches, one journal reopen.  Every
    # one of these counts is probe-pinned, so a round-over-round rise
    # is a behavioral regression, not workload noise: extra accepts or
    # rejects mean admission drifted, extra redispatches mean spurious
    # worker losses (a stall-budget or heartbeat regression), extra
    # replays mean journals started reopening when they shouldn't.
    "gateway.accepted",
    "gateway.rejected",
    "gateway.redispatched",
    "gateway.journal_replays",
)

#: counters REPORTED round-over-round but never failed: how
#: many alert rules fired is incident evidence the diff should surface
#: next to the perf verdict, but firing count is workload-shaped (a
#: fault-injection round SHOULD fire) — a rise is information, not a
#: regression
INFO_COUNTERS = (
    "alerts.fired",
)


def load_counters(path: str) -> dict | None:
    """Counter table ``{name: {labels: value}}`` from the same shapes
    :func:`load_phases` reads, or None when the source carries none."""
    p = pathlib.Path(path)
    try:
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
                    continue
                if isinstance(rec, dict) and "counters" in rec:
                    last = rec
            return dict(last["counters"]) if last else None
        data = json.loads(text)
        if "counters" in data:
            return dict(data["counters"])
        tel = (data.get("detail") or {}).get("telemetry") or {}
        if "counters" in tel:
            return dict(tel["counters"])
    except (OSError, ValueError, json.JSONDecodeError):
        pass
    return None


def compare_counters(current: dict | None, baseline: dict | None,
                     threshold: float = 0.35,
                     counters=GATED_COUNTERS,
                     informational=()) -> dict:
    """Round-over-round gate on counter TOTALS (labels summed).  Either
    side missing the table (old rounds, bench records without counters)
    passes vacuously — the gate only engages once both rounds carry
    counter evidence.  ``informational`` counters are tabulated the same
    way but can never fail the gate (status ``info``)."""
    rows = []
    failures = []
    if current is None or baseline is None:
        return {"verdict": "PASS", "rows": rows, "failures": failures}
    info = set(informational)
    for name in tuple(counters) + tuple(informational):
        b = baseline.get(name)
        c = current.get(name)
        if b is None:
            if name in info and c:
                # informational counters surface even without baseline
                # history — new alert activity is evidence, not a fail
                rows.append({"counter": name, "base_total": 0,
                             "cur_total": sum(c.values()),
                             "status": "info"})
            continue
        b_tot = sum(b.values())
        c_tot = sum(c.values()) if c else 0
        row = {"counter": name, "base_total": b_tot, "cur_total": c_tot}
        if name in info:
            row["status"] = "info"
            if b_tot > 0:
                row["ratio"] = round(c_tot / b_tot, 3)
        elif b_tot > 0:
            ratio = c_tot / b_tot
            row["ratio"] = round(ratio, 3)
            if ratio > 1.0 + threshold:
                row["status"] = "REGRESSED"
                failures.append(
                    f"{name}: total {b_tot} -> {c_tot} ({ratio:.2f}x, "
                    f"threshold {1 + threshold:.2f}x)"
                )
            else:
                row["status"] = "ok"
        else:
            row["status"] = "ok" if c_tot == 0 else "new-activity"
        rows.append(row)
    return {
        "verdict": "FAIL" if failures else "PASS",
        "rows": rows,
        "failures": failures,
    }

#: phases reported but never gated (merged with --allow): the
#: resilience phases time fault-injection rounds and recovery scans,
#: whose cost is dominated by how many faults the round armed and how
#: many generations the scan had to skip — round-over-round variation
#: there is workload-shaped, not a perf regression.  Same for the
#: trace-processing phases: ingest/merge cost scales with how
#: many spans the profiled round happened to capture.
DEFAULT_ALLOW = (
    "lineage.commit",
    "lineage.scan",
    "xplane.ingest",
    "trace.merge",
    # halo-backend phase: the oracle cross-check replays every
    # exchange on the collective path when DCCRG_HALO_VERIFY=1 — its
    # cost scales with how many exchanges the round chose to verify,
    # which is workload-shaped, not a perf regression
    "halo.verify",
    # elastic phases: a rescale is checkpoint-commit + reload +
    # verify, and a supervisor poll is file tailing — both are sized by
    # how many rescales/stalls the round happened to drive (one-off
    # rescale spikes are the MECHANISM working, not a regression)
    "elastic.rescale",
    "supervisor.poll",
    # ensemble phases: admit cost scales with how many scenarios
    # the round submitted and step cost with the cohort widths it chose
    # to drive; the verify phase replays solo members on demand — all
    # workload-shaped.  The regression the gate DOES watch is the
    # cohort-occupancy floor (GATED_GAUGES_MIN) and the recompile
    # counter: a serving round that starts retracing or fragmenting its
    # cohorts fails there, not on wall time.
    "ensemble.admit",
    "ensemble.step",
    "ensemble.verify",
    # flight-recorder phase: a dump's cost is sized by the ring
    # contents and how many postmortems the round's incidents triggered
    # — workload-shaped, not a perf regression.  The SLO regression the
    # gate DOES watch is the request-latency quantile ceiling
    # (GATED_QUANTILES below).
    "flightrec.dump",
    # live-telemetry phases: an aggregator poll is sized by how
    # many stream files grew and by how much, an alert evaluation by how
    # many rules the run configured — both workload-shaped.  The alert
    # OUTCOME is surfaced via the informational alerts.fired counter.
    "live.poll",
    "alerts.evaluate",
    # cost plane: an admission estimate runs once per submitted
    # scenario, so its total scales with how many scenarios a probe
    # round submits — workload-shaped.  The OUTCOME the gate watches is
    # ensemble.deadline_miss (GATED_COUNTERS above): the model-driven
    # clamp must not miss more deadlines than the EMA-only baseline.
    "cost.estimate",
)

#: gauges gated round-over-round where a DROP is the regression: the
#: measured halo overlap fraction falling means communication stopped
#: hiding under compute — exactly what the device-timeline plane exists
#: to catch.  Engages only when both rounds carry the gauge (older
#: rounds and deviceless backends pass vacuously).  The floor applies
#: PER LABELED SERIES, so the per-model gauges
#: (``overlap.fraction{model=advection|vlasov, phase=halo}`` from the
#: fused split-phase probe rounds) are each gated — and one going
#: missing is a coverage loss — the moment a baseline round carries
#: them.
GATED_GAUGES_MIN = (
    "overlap.fraction",
    # highest occupied fraction each cohort reached (labeled by
    # the cross-process-stable signature).  A DROP means admissions
    # stopped packing scenarios into shared executables — cohort
    # fragmentation, exactly the regression ensemble serving exists to
    # prevent.  Monotone per round by construction (a peak), so the
    # floor is meaningful where live occupancy (which legitimately
    # returns to 0 after retirement) would be noise.
    "ensemble.cohort_peak_occupancy",
)

#: gauges gated round-over-round where a RISE is the regression:
#: per-member cohort memory (unique table buffers + the
#: in-flight state cost, per ``obs/hbm.py``) is exactly what buffer
#: donation and broadcast-shared tables bought down — a round where it
#: climbs back past the ceiling means stacked table copies or the
#: dispatch-time state double-buffer crept back in, the scenarios-per-
#: chip regression this gate exists to catch.  Engages only when both
#: rounds carry the gauge; per labeled series (one per model kind).
GATED_GAUGES_MAX = (
    "ensemble.hbm_bytes_per_member",
    # headline: cumulative exchanges per interior step, ~1/k
    # with wide halos engaged, 1.0 legacy.  A round where it climbs
    # past the ceiling means dispatches stopped amortizing the halo
    # exchange — the regression exchange-amortized deep dispatch
    # exists to prevent.  Per labeled series (one per model kind).
    "halo.exchanges_per_step",
)


#: request-latency histograms whose upper quantile is CEILING-gated
#: round-over-round: per labeled series, the current round's
#: p99 may not exceed the baseline's by more than the threshold — the
#: request-level analogue of the phase-mean gate.  Engages only when
#: both rounds carry the series with enough samples; the quantile comes
#: from the exported log buckets (obs/slo.py), so the gate needs no
#: live process.
GATED_QUANTILES = (
    ("ensemble.queue_wait_s", 0.99),
    ("ensemble.e2e_s", 0.99),
    ("ensemble.service_s", 0.99),
)

#: baseline p99s below this many seconds are bucket-resolution noise,
#: not a meaningful ceiling (a 50µs p99 doubling is jitter)
QUANTILE_MIN_BASE_S = 1e-4

_SLO = None


def _slo():
    """The quantile estimator (the port's ``obs/slo.py``), imported at
    first use."""
    global _SLO
    if _SLO is None:
        from ..obs import slo

        _SLO = slo
    return _SLO


def load_histograms(path: str) -> dict | None:
    """Histogram table ``{name: {labels: hist}}`` from the same shapes
    :func:`load_phases` reads, or None when the source carries none."""
    p = pathlib.Path(path)
    try:
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
                    continue
                if isinstance(rec, dict) and "histograms" in rec:
                    last = rec
            return dict(last["histograms"]) if last else None
        data = json.loads(text)
        if "histograms" in data:
            return dict(data["histograms"])
        tel = (data.get("detail") or {}).get("telemetry") or {}
        if "histograms" in tel:
            return dict(tel["histograms"])
    except (OSError, ValueError, json.JSONDecodeError):
        pass
    return None


def compare_quantiles(current: dict | None, baseline: dict | None,
                      threshold: float = 0.35, gated=GATED_QUANTILES,
                      min_base_s: float = QUANTILE_MIN_BASE_S,
                      min_count: int = 2) -> dict:
    """Ceiling gate on per-label latency quantiles: fails when a gated
    series' quantile exceeds ``baseline * (1 + threshold)``.  Either
    side lacking the table, the series, or enough samples passes
    vacuously — label sets legitimately differ per round (tenants come
    and go), so a missing label only informs."""
    rows = []
    failures = []
    if current is None or baseline is None:
        return {"verdict": "PASS", "rows": rows, "failures": failures}
    slo = _slo()
    for name, q in gated:
        base_series = baseline.get(name)
        if not base_series:
            continue
        cur_series = current.get(name) or {}
        for label, bh in base_series.items():
            ch = cur_series.get(label)
            row = {"histogram": name, "labels": label, "q": q}
            if not isinstance(bh, dict) or bh.get("count", 0) < min_count:
                row["status"] = "below-sample-floor"
                rows.append(row)
                continue
            bq = slo.quantile(bh, q)
            row["base"] = bq
            if ch is None or not isinstance(ch, dict) \
                    or ch.get("count", 0) < min_count:
                row["status"] = "missing-label"
                rows.append(row)
                continue
            cq = slo.quantile(ch, q)
            row["cur"] = cq
            if bq is None or cq is None or bq < min_base_s:
                row["status"] = "below-noise-floor"
            elif cq > bq * (1.0 + threshold):
                row["status"] = "REGRESSED"
                row["ratio"] = round(cq / bq, 3)
                failures.append(
                    f"{name}{{{label}}} p{round(q * 100)}: "
                    f"{bq:.6f}s -> {cq:.6f}s ({cq / bq:.2f}x, ceiling "
                    f"{1 + threshold:.2f}x)"
                )
            else:
                row["status"] = "ok"
                row["ratio"] = round(cq / max(bq, 1e-12), 3)
            rows.append(row)
    return {
        "verdict": "FAIL" if failures else "PASS",
        "rows": rows,
        "failures": failures,
    }


def load_gauges(path: str) -> dict | None:
    """Gauge table ``{name: {labels: value}}`` from the same shapes
    :func:`load_phases` reads, or None when the source carries none."""
    p = pathlib.Path(path)
    try:
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
                    continue
                if isinstance(rec, dict) and "gauges" in rec:
                    last = rec
            return dict(last["gauges"]) if last else None
        data = json.loads(text)
        if "gauges" in data:
            return dict(data["gauges"])
        tel = (data.get("detail") or {}).get("telemetry") or {}
        if "gauges" in tel:
            return dict(tel["gauges"])
    except (OSError, ValueError, json.JSONDecodeError):
        pass
    return None


def compare_gauges(current: dict | None, baseline: dict | None,
                   threshold: float = 0.35,
                   gauges=GATED_GAUGES_MIN, mode: str = "min") -> dict:
    """Directional gate on per-label gauge values.  ``mode="min"``
    (floor): fails when a gated gauge DROPS below ``baseline * (1 -
    threshold)`` — regression direction is down, these are goodness
    fractions.  ``mode="max"`` (ceiling): fails when it
    RISES above ``baseline * (1 + threshold)`` — regression direction
    is up, these are costs (per-member HBM).  A labeled series present
    in the baseline but missing from the current round is a coverage
    loss and fails; either side lacking the whole table passes
    vacuously."""
    rows = []
    failures = []
    if mode not in ("min", "max"):
        raise ValueError(f"unknown gauge-gate mode {mode!r}")
    if current is None or baseline is None:
        return {"verdict": "PASS", "rows": rows, "failures": failures}
    for name in gauges:
        base_series = baseline.get(name)
        if not base_series:
            continue
        cur_series = current.get(name) or {}
        for label, b in base_series.items():
            c = cur_series.get(label)
            row = {"gauge": name, "labels": label, "base": b, "cur": c}
            if c is None:
                row["status"] = "MISSING"
                failures.append(
                    f"{name}{{{label}}}: present in baseline ({b}), "
                    "missing from current round (coverage loss)"
                )
            elif not isinstance(b, (int, float)) or b <= 0:
                row["status"] = "ok"  # nothing to regress from
            elif mode == "min" and c < b * (1.0 - threshold):
                row["status"] = "REGRESSED"
                failures.append(
                    f"{name}{{{label}}}: {b} -> {c} "
                    f"(below {1 - threshold:.2f}x floor)"
                )
            elif mode == "max" and c > b * (1.0 + threshold):
                row["status"] = "REGRESSED"
                failures.append(
                    f"{name}{{{label}}}: {b} -> {c} "
                    f"(above {1 + threshold:.2f}x ceiling)"
                )
            else:
                row["status"] = "ok"
            rows.append(row)
    return {
        "verdict": "FAIL" if failures else "PASS",
        "rows": rows,
        "failures": failures,
    }


def load_phases(path: str) -> dict:
    """Phase table ``{name: {total_s, count, mean_s}}`` from any of the
    telemetry-bearing shapes this repo produces:

    * ``telemetry.json`` — top-level ``phases``;
    * ``BENCH_DETAIL.json`` / ``BENCH_r*.json`` records —
      ``detail.telemetry.phases``;
    * a streaming ``*.jsonl`` — the LAST complete line's ``phases``
      (cumulative, so the last snapshot is the round's final state).
    """
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
            if isinstance(rec, dict) and "phases" in rec:
                last = rec
        if last is None:
            raise ValueError(f"{path}: no snapshot line carries 'phases'")
        return dict(last["phases"])
    data = json.loads(text)
    if "phases" in data:
        return dict(data["phases"])
    tel = (data.get("detail") or {}).get("telemetry") or {}
    if "phases" in tel:
        return dict(tel["phases"])
    raise ValueError(f"{path}: no phase table found (not telemetry.json, "
                     "a bench record, or a telemetry JSONL stream)")


def discover_baseline(current: str = str(DEFAULT_TELEMETRY)) -> str | None:
    """The prior round beside ``current``: ``telemetry_prev.json`` in its
    directory, when it holds a phase table."""
    prev = pathlib.Path(current).resolve().parent / "telemetry_prev.json"
    if prev.exists():
        try:
            load_phases(str(prev))
            return str(prev)
        except (ValueError, json.JSONDecodeError):
            pass
    return None


def compare(current: dict, baseline: dict, threshold: float = 0.35,
            phases=None, allow=(), min_total: float = 1e-3) -> dict:
    """Pure comparison -> verdict record.  ``current``/``baseline`` are
    phase tables; ``phases`` limits the gate (None = every baseline
    phase); ``allow`` lists phases that may regress without failing."""
    gate = set(phases) if phases else set(baseline)
    allow = set(allow)
    rows = []
    failures = []
    for name in sorted(set(baseline) | set(current)):
        b, c = baseline.get(name), current.get(name)
        row = {"phase": name}
        if b is not None:
            row["base_mean_s"] = round(
                b.get("mean_s", b["total_s"] / max(b.get("count", 1), 1)), 6
            )
            row["base_total_s"] = round(b["total_s"], 6)
        if c is not None:
            row["cur_mean_s"] = round(
                c.get("mean_s", c["total_s"] / max(c.get("count", 1), 1)), 6
            )
        gated = name in gate and name not in allow
        if b is None:
            row["status"] = "new"
        elif name not in gate:
            row["status"] = "ungated"
        elif b["total_s"] < min_total:
            row["status"] = "below-noise-floor"
        elif c is None:
            row["status"] = "allowed-missing" if not gated else "MISSING"
            if gated:
                failures.append(f"{name}: present in baseline, missing "
                                "from current round (coverage loss)")
        else:
            ratio = row["cur_mean_s"] / max(row["base_mean_s"], 1e-12)
            row["ratio"] = round(ratio, 3)
            if ratio > 1.0 + threshold:
                row["status"] = "allowed-regression" if not gated else "REGRESSED"
                if gated:
                    failures.append(
                        f"{name}: mean {row['base_mean_s']:.6f}s -> "
                        f"{row['cur_mean_s']:.6f}s ({ratio:.2f}x, "
                        f"threshold {1 + threshold:.2f}x)"
                    )
            else:
                row["status"] = "ok"
        rows.append(row)
    return {
        "verdict": "FAIL" if failures else "PASS",
        "threshold": threshold,
        "min_total_s": min_total,
        "allow": sorted(allow),
        "failures": failures,
        "rows": rows,
    }


def load_history(path: str) -> list:
    """The retained rounds from a phase-history JSONL, oldest first.
    Unparseable or phase-less lines are skipped (a killed writer leaves
    earlier complete lines intact)."""
    out = []
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and isinstance(
                    rec.get("phases"), dict
                ):
                    out.append(rec)
    except OSError:
        pass
    return out


def append_history(path: str, phases: dict, keep: int,
                   source: str = "") -> None:
    """Append this round's phase table and trim to the last ``keep``
    rounds (atomic rewrite)."""
    history = load_history(path)
    history.append({"source": source, "phases": phases})
    history = history[-max(keep, 1):]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for rec in history:
            f.write(json.dumps(rec) + "\n")
    os.replace(tmp, path)


def check_drift(current: dict, oldest: dict, threshold: float = 0.75,
                phases=None, allow=(), min_total: float = 1e-3) -> dict:
    """Cumulative-drift gate: the same mean-per-span comparison as
    :func:`compare`, but against the OLDEST retained round — a phase
    creeping +10% every round stays inside the step threshold forever
    yet doubles over the window; this catches it.  Coverage loss is the
    step gate's job, so a phase missing from the current round does not
    fail here."""
    v = compare(current, oldest, threshold=threshold, phases=phases,
                allow=allow, min_total=min_total)
    failures = []
    for row in v["rows"]:
        if row["status"] == "REGRESSED":
            row["status"] = "DRIFT"
            failures.append(
                f"{row['phase']}: cumulative drift "
                f"{row['base_mean_s']:.6f}s -> {row['cur_mean_s']:.6f}s "
                f"({row['ratio']:.2f}x over the retained window, "
                f"threshold {1 + threshold:.2f}x)"
            )
        elif row["status"] == "allowed-regression":
            row["status"] = "allowed-drift"
        elif row["status"] == "MISSING":
            row["status"] = "ungated"
    return {
        "verdict": "FAIL" if failures else "PASS",
        "threshold": threshold,
        "failures": failures,
        "rows": v["rows"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--current", default=str(DEFAULT_TELEMETRY),
                    help="this round's telemetry (json or jsonl stream)")
    ap.add_argument("--baseline", default=None,
                    help="previous round (default: auto-discover)")
    ap.add_argument("--threshold", type=float, default=0.35,
                    help="max allowed fractional mean-time regression")
    ap.add_argument("--min-total", type=float, default=1e-3,
                    help="skip phases whose baseline total_s is below this")
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated gated phases ('' = all)")
    ap.add_argument("--allow", action="append", default=[],
                    help="phase allowed to regress (repeatable, or "
                         "comma-separated; the resilience phases "
                         f"{', '.join(DEFAULT_ALLOW)} are always allowed)")
    ap.add_argument("--json", default=None,
                    help="also write the verdict record to this path")
    ap.add_argument("--history", default=None,
                    help="phase-history JSONL: each run appends its "
                         "phase table and drift-checks against the "
                         "oldest retained round (default: "
                         "telemetry_history.jsonl beside --current)")
    ap.add_argument("--no-history", action="store_true",
                    help="neither append to nor drift-check the history")
    ap.add_argument("--history-keep", type=int, default=10,
                    help="rounds retained in the history window")
    ap.add_argument("--drift-threshold", type=float, default=0.75,
                    help="max allowed fractional mean-time drift vs the "
                         "oldest retained round")
    args = ap.parse_args(argv)

    baseline_path = args.baseline or discover_baseline(args.current)
    if baseline_path is None:
        print("telemetry_diff: no baseline round found — PASS (vacuous); "
              "keep a previous round's telemetry.json as telemetry_prev.json "
              "beside --current to establish one", file=sys.stderr)
        return 0
    if args.history is None:
        args.history = str(pathlib.Path(args.current).resolve().parent
                           / "telemetry_history.jsonl")
    try:
        current = load_phases(args.current)
        baseline = load_phases(baseline_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"telemetry_diff: cannot load inputs: {e}", file=sys.stderr)
        return 2
    allow = list(DEFAULT_ALLOW) + [
        a for chunk in args.allow for a in chunk.split(",") if a
    ]
    phases = [p for p in args.phases.split(",") if p] or None
    verdict = compare(current, baseline, threshold=args.threshold,
                      phases=phases, allow=allow, min_total=args.min_total)
    verdict["current"] = str(args.current)
    verdict["baseline"] = str(baseline_path)

    # counter gate (epoch.recompiles): engages when both rounds carry
    # counter tables
    cgate = compare_counters(
        load_counters(args.current), load_counters(baseline_path),
        threshold=args.threshold, informational=INFO_COUNTERS,
    )
    verdict["counter_gate"] = cgate
    if cgate["verdict"] == "FAIL":
        verdict["verdict"] = "FAIL"
        verdict["failures"] = list(verdict["failures"]) + cgate["failures"]

    # gauge floor gate (overlap.fraction): engages when both rounds
    # carry the gauge — a drop means compute stopped hiding the halo
    cur_gauges = load_gauges(args.current)
    base_gauges = load_gauges(baseline_path)
    ggate = compare_gauges(cur_gauges, base_gauges,
                           threshold=args.threshold)
    verdict["gauge_gate"] = ggate
    if ggate["verdict"] == "FAIL":
        verdict["verdict"] = "FAIL"
        verdict["failures"] = list(verdict["failures"]) + ggate["failures"]

    # gauge ceiling gate: per-member cohort HBM may not rise
    # past the baseline — the donation + shared-table wins are regress-
    # able costs, not one-time events
    cgate_max = compare_gauges(cur_gauges, base_gauges,
                               threshold=args.threshold,
                               gauges=GATED_GAUGES_MAX, mode="max")
    verdict["gauge_ceiling_gate"] = cgate_max
    if cgate_max["verdict"] == "FAIL":
        verdict["verdict"] = "FAIL"
        verdict["failures"] = (list(verdict["failures"])
                               + cgate_max["failures"])

    # quantile ceiling gate: the request-latency p99s may
    # not blow past the baseline's — a serving round whose tail latency
    # regressed fails even when every phase MEAN stayed flat (tails
    # hide in means; that is the point of the SLO plane)
    qgate = compare_quantiles(
        load_histograms(args.current), load_histograms(baseline_path),
        threshold=args.threshold,
    )
    verdict["quantile_gate"] = qgate
    if qgate["verdict"] == "FAIL":
        verdict["verdict"] = "FAIL"
        verdict["failures"] = list(verdict["failures"]) + qgate["failures"]

    # cumulative-drift gate over the retained history window (the
    # round-over-round step gate above cannot see slow creep)
    hist_path = None if args.no_history else args.history
    if hist_path:
        history = load_history(hist_path)
        if len(history) >= 2:
            drift = check_drift(
                current, history[0]["phases"],
                threshold=args.drift_threshold, phases=phases,
                allow=allow, min_total=args.min_total,
            )
            drift["baseline_source"] = history[0].get("source", "")
            drift["rounds_spanned"] = len(history)
            verdict["drift"] = drift
            verdict["failures"] = (
                list(verdict["failures"]) + list(drift["failures"])
            )
            if drift["verdict"] == "FAIL":
                verdict["verdict"] = "FAIL"
        append_history(hist_path, current, args.history_keep,
                       source=str(args.current))

    for row in verdict["rows"]:
        parts = [f"{row['phase']:24s} {row['status']:>18s}"]
        if "base_mean_s" in row and "cur_mean_s" in row:
            parts.append(f"{row['base_mean_s']:.6f}s -> "
                         f"{row['cur_mean_s']:.6f}s")
            if "ratio" in row:
                parts.append(f"({row['ratio']:.2f}x)")
        print("  ".join(parts))
    if verdict["quantile_gate"]["rows"]:
        qg = verdict["quantile_gate"]
        gated_n = sum(1 for r in qg["rows"]
                      if r["status"] in ("ok", "REGRESSED"))
        print(f"telemetry_diff: p99 ceiling {qg['verdict']} "
              f"({gated_n} labeled series gated, threshold "
              f"{1 + args.threshold:.2f}x)")
    if "drift" in verdict:
        d = verdict["drift"]
        print(f"telemetry_diff: drift {d['verdict']} vs oldest of "
              f"{d['rounds_spanned']} retained rounds "
              f"(threshold {1 + d['threshold']:.2f}x)")
    print(f"telemetry_diff: {verdict['verdict']} "
          f"({args.current} vs {baseline_path}, "
          f"threshold {1 + args.threshold:.2f}x)")
    for f in verdict["failures"]:
        print(f"  REGRESSION: {f}", file=sys.stderr)
    if args.json:
        tmp = args.json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(verdict, f, indent=1)
        os.replace(tmp, args.json)
    return 1 if verdict["verdict"] == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
