"""Cost & capacity plane: online step-cost models, per-tenant
chargeback, and predicted queue-wait estimates.

The SLO plane (``obs/slo.py``) answers "what happened"; the live plane
(``obs/live.py``) answers "what is happening"; this module answers
"what will it cost".  Three pieces, all built on the registry's
exported log-bucket histograms so everything merges across processes
with the same exactness proof the SLO plane established:

* :class:`StepCostModel` — an online per-key cost model of cohort
  dispatch time.  The key is ``(model, sig_label, k, g, W)``: the model
  kind, the grid shape-signature label, the deep-dispatch depth, the
  wide-halo exchange depth and the cohort width — every dimension that
  selects a distinct compiled cohort body, because distinct executables
  have distinct costs.  Per key it keeps a streaming mean/variance
  (count, sum, sum-of-squares — all merge by addition) and a log-bucket
  histogram at ``SLO_RESOLUTION`` (~9% edges).  Samples are
  PER-INTERIOR-STEP wall seconds (``dispatch_wall / k``), so estimates
  compare across depths.  Every observation is forwarded to the shared
  registry (``cost.step_s{g,k,model,sig,w}`` histogram +
  ``cost.step_s_sq`` counter), so exported snapshots carry the model
  and merging exports rebuilds the exact fleet model
  (:meth:`StepCostModel.ingest` / :meth:`StepCostModel.from_reports`).

  :meth:`StepCostModel.predict` returns a :class:`CostEstimate` with a
  documented cold-start fallback chain — **exact key → same-model
  any-signature → global** — so a fresh (signature, k, g, W) cell still
  gets an estimate from its model's other bodies, and a fresh model
  from the fleet at large; ``level`` names which rung answered.

* **chargeback** (:func:`chargeback` / :func:`conservation`) — a
  per-tenant ledger attributed from series the serving stack already
  records: device-seconds from ``ensemble.device_s{tenant,model}``
  (each dispatch bills ``wall × mesh devices`` split by the
  member-steps each tenant advanced), member-steps from
  ``ensemble.steps_served{tenant}``, halo exchanges from the
  ``halo.exchanges_per_step{model}`` gauge times the tenant's
  per-model step attribution, and compile seconds / recompiles from
  the ``compile`` phase and ``epoch.recompiles`` split by device-share.
  The conservation invariant — attributed device-seconds sum to the
  recorded ``ensemble.device_s_total`` wall×mesh total within one
  histogram bucket — is asserted by ``tests/test_cost.py`` and the
  ``check_telemetry`` cost probe.

* **capacity** (:class:`ServiceRateTracker`, :func:`predicted_wait`,
  :func:`queue_wait_estimates`) — predicted queue-wait per tenant:
  backlog (queued member-steps, the ``ensemble.queue_depth_steps``
  gauge) over the measured service rate.  The write side tracks rates
  in-process (steps per busy-second over a sliding window) and surfaces
  ``cost.predicted_queue_wait_s{tenant}`` gauges; the read side
  (:func:`queue_wait_estimates`) recomputes them from a live
  :class:`~dccrg_tpu_torch.obs.live.FleetView`'s bucket-delta windows.  A
  tenant with no serving history borrows the fleet rate scaled by its
  backlog share (the FIFO-position estimate).  The estimate is the wait
  of the NEWEST queued request — for a burst that brackets the measured
  per-tenant queue-wait p95, and the calibration target is ONE OCTAVE
  bucket (:data:`CALIBRATION_BUCKET`, a factor of two): predictions are
  admission advice, not latency SLOs.

Who consumes it: ``Scheduler.select_k`` divides deadline slack by the
model's ``DCCRG_COST_QUANTILE`` (default p95) per-step estimate instead
of the cohort-local EMA once ``DCCRG_COST_MIN_SAMPLES`` samples exist
(``DCCRG_COST_MODEL=0`` restores the EMA path byte-for-byte);
``Scheduler.submit`` counts cost-based admission ADVICE
(``ensemble.admission_estimates{verdict}`` — counted, never raised);
``tools/cost_report.py`` and ``fleet_top.py --cost`` are the consoles.

Module-level imports are stdlib-only.  A copy of the JAX package's
``obs/cost.py`` without its file-load fallback (the consoles load the JAX
package's copy; the report format is the same).
"""
from __future__ import annotations

import collections
import math
import os
import threading
import time

from .slo import (
    SLO_RESOLUTION,
    merge as _slo_merge,
    quantile as _slo_quantile,
)
from .registry import metrics as _metrics

__all__ = [
    "COST_HISTOGRAM",
    "COST_SUMSQ",
    "COST_RESOLUTION",
    "CALIBRATION_BUCKET",
    "CostEstimate",
    "StepCostModel",
    "ServiceRateTracker",
    "enabled",
    "min_samples",
    "quantile_target",
    "key_labels",
    "key_label",
    "parse_label",
    "record_dispatch",
    "predicted_wait",
    "queue_wait_estimates",
    "chargeback",
    "conservation",
    "cost_summary",
    "model",
    "tracker",
]

#: the per-interior-step dispatch-cost histogram the write side records
COST_HISTOGRAM = "cost.step_s"
#: companion sum-of-squares counter (counters merge by addition, so the
#: streaming variance merges across processes exactly like the buckets)
COST_SUMSQ = "cost.step_s_sq"
#: bucket resolution of the cost series — the SLO grain (~9% edges), so
#: cross-process merges of cost exports are exact like the latency ones
COST_RESOLUTION = SLO_RESOLUTION
#: calibration envelope for queue-wait predictions: one OCTAVE bucket
#: (factor 2).  Predictions feed admission advice and k-selection, not
#: latency SLOs — a factor-2 bracket is the documented quality target
#: the tests and the CI probe hold them to.
CALIBRATION_BUCKET = 2.0


def enabled() -> bool:
    """Whether the cost model is armed (``DCCRG_COST_MODEL``, default
    on).  ``0`` disables recording, prediction, admission advice and
    the model-driven ``select_k`` clamp — the scheduler path is then
    byte-identical to the pre-cost EMA behavior."""
    return os.environ.get("DCCRG_COST_MODEL", "1") != "0"


def min_samples() -> int:
    """Samples a prediction needs (at its answering fallback level)
    before the scheduler trusts it over the cohort-local EMA
    (``DCCRG_COST_MIN_SAMPLES``, default 8)."""
    try:
        n = int(os.environ.get("DCCRG_COST_MIN_SAMPLES", "8"))
    except ValueError:
        return 8
    return max(n, 1)


def quantile_target() -> float:
    """The quantile the scheduler's slack clamp consumes
    (``DCCRG_COST_QUANTILE``, default 0.95).  p95, not the mean: a
    deadline clamp sized to the mean overshoots half the time."""
    try:
        q = float(os.environ.get("DCCRG_COST_QUANTILE", "0.95"))
    except ValueError:
        return 0.95
    return min(max(q, 0.01), 0.999)


# ------------------------------------------------------------------ keys

def key_labels(model: str, sig: str, k: int, g: int, w: int) -> dict:
    """The label dict of one cost-model key."""
    return {"model": str(model), "sig": str(sig), "k": int(k),
            "g": int(g), "w": int(w)}


def key_label(model: str, sig: str, k: int, g: int, w: int) -> str:
    """The registry's canonical label string for one key (labels sort
    alphabetically: ``g,k,model,sig,w``) — the exported series key."""
    labels = key_labels(model, sig, k, g, w)
    return ",".join(f"{k_}={v}" for k_, v in
                    sorted((str(a), str(b)) for a, b in labels.items()))


def parse_label(label: str) -> dict:
    """Inverse of :func:`key_label` (string values)."""
    return dict(kv.split("=", 1)
                for kv in (label or "").split(",") if "=" in kv)


def _bucket_key(value: float, res: int = COST_RESOLUTION) -> str:
    """The registry's exported bucket key for ``value`` at resolution
    ``res`` — the same edge computation ``MetricsRegistry.observe``
    performs, so the model's local store and the registry's export hold
    IDENTICAL bucket keys (the exact-merge property depends on it)."""
    if value <= 0.0:
        return "0"
    m, e = math.frexp(value)
    if m == 0.5:
        e -= 1
    exp = float(e)
    if res > 1:
        k = math.ceil(math.log2(value) * res)
        while 2.0 ** (k / res) < value:      # fp guard
            k += 1
        while 2.0 ** ((k - 1) / res) >= value:
            k -= 1
        exp = k / res
    return str(2.0 ** exp)


#: one prediction: quantiles + moments + how many samples answered and
#: from which fallback rung (``exact`` / ``model`` / ``global``)
CostEstimate = collections.namedtuple(
    "CostEstimate", "p50 p95 q_value n level mean std q")


class StepCostModel:
    """Online per-key dispatch-cost model (see the module docstring).

    ``registry`` is the shared :class:`MetricsRegistry` observations
    forward to (None = keep the model local, the read-side form).  The
    local store mirrors the registry's exported histogram shape exactly
    — same bucket-edge math — so :meth:`predict` never has to rebuild a
    full registry report on the scheduler's hot path.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        #: label string -> {"count","sum","min","max","buckets"}
        self._series: dict = {}
        #: label string -> sum of squared samples
        self._sumsq: dict = {}
        self._registry = registry if registry is not None else _metrics
        if self._registry is not None:
            try:
                self._registry.set_histogram_resolution(
                    COST_HISTOGRAM, COST_RESOLUTION)
            except AttributeError:
                pass
        #: revision counter invalidating the merged fallback caches
        self._rev = 0
        self._model_cache: dict = {}   # model -> (rev, hist, sumsq)
        self._global_cache = None      # (rev, hist, sumsq)

    # -------------------------------------------------------- writes

    def observe(self, model: str, sig: str, k: int, g: int, w: int,
                step_s: float) -> None:
        """Record one per-interior-step wall-seconds sample for a key,
        locally and into the shared registry's exported series."""
        step_s = float(step_s)
        label = key_label(model, sig, k, g, w)
        bucket = _bucket_key(step_s)
        with self._lock:
            h = self._series.get(label)
            if h is None:
                h = self._series[label] = {
                    "count": 0, "sum": 0.0, "min": step_s, "max": step_s,
                    "buckets": {},
                }
            h["count"] += 1
            h["sum"] += step_s
            h["min"] = min(h["min"], step_s)
            h["max"] = max(h["max"], step_s)
            h["buckets"][bucket] = h["buckets"].get(bucket, 0) + 1
            self._sumsq[label] = self._sumsq.get(label, 0.0) + step_s ** 2
            self._rev += 1
        reg = self._registry
        if reg is not None and getattr(reg, "enabled", False):
            labels = key_labels(model, sig, k, g, w)
            reg.observe(COST_HISTOGRAM, step_s, **labels)
            reg.inc(COST_SUMSQ, step_s ** 2, **labels)

    def ingest(self, report: dict) -> None:
        """Merge one exported report's cost series into this model —
        the cross-process form.  Exact: equal samples produced equal
        bucket keys on both sides, so ingesting every child's export
        equals one process having observed everything."""
        series = (report.get("histograms") or {}).get(COST_HISTOGRAM) or {}
        sumsq = (report.get("counters") or {}).get(COST_SUMSQ) or {}
        with self._lock:
            for label, h in series.items():
                if not h or not h.get("count"):
                    continue
                mine = self._series.get(label)
                self._series[label] = (_slo_merge(mine, h) if mine
                                       else _slo_merge(h))
            for label, v in sumsq.items():
                self._sumsq[label] = self._sumsq.get(label, 0.0) + float(v)
            self._rev += 1

    @classmethod
    def from_reports(cls, reports) -> "StepCostModel":
        """A read-side fleet model from exported report dicts."""
        m = cls(registry=False)
        m._registry = None
        for rep in reports:
            m.ingest(rep or {})
        return m

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._sumsq.clear()
            self._model_cache.clear()
            self._global_cache = None
            self._rev += 1

    # --------------------------------------------------------- reads

    def keys(self) -> list:
        """Observed key label strings, sorted."""
        with self._lock:
            return sorted(self._series)

    def series(self) -> dict:
        """``{label: hist}`` snapshot (exported histogram shape)."""
        with self._lock:
            return {lb: dict(h, buckets=dict(h["buckets"]))
                    for lb, h in self._series.items()}

    def export(self) -> dict:
        """A report fragment carrying the model (histograms + sum-of-
        squares counters) — the shape :meth:`ingest` consumes."""
        with self._lock:
            hists = {lb: dict(h, buckets=dict(h["buckets"]),
                              mean=h["sum"] / max(h["count"], 1))
                     for lb, h in self._series.items()}
            sumsq = dict(self._sumsq)
        return {"histograms": {COST_HISTOGRAM: hists},
                "counters": {COST_SUMSQ: sumsq}}

    def sample_count(self) -> int:
        with self._lock:
            return sum(h["count"] for h in self._series.values())

    def _merged(self, model=None):
        """(hist, sumsq) merged over keys matching ``model`` (None =
        global), cached per revision."""
        with self._lock:
            rev = self._rev
            if model is None:
                if self._global_cache and self._global_cache[0] == rev:
                    return self._global_cache[1], self._global_cache[2]
                picked = list(self._series.items())
            else:
                hit = self._model_cache.get(model)
                if hit and hit[0] == rev:
                    return hit[1], hit[2]
                want = str(model)
                picked = [(lb, h) for lb, h in self._series.items()
                          if parse_label(lb).get("model") == want]
            hist = _slo_merge(*(h for _, h in picked)) if picked else {}
            sq = sum(self._sumsq.get(lb, 0.0) for lb, _ in picked)
            if model is None:
                self._global_cache = (rev, hist, sq)
            else:
                self._model_cache[model] = (rev, hist, sq)
            return hist, sq

    def predict(self, model: str, sig=None, k=None, g=None, w=None,
                q: float | None = None):
        """Cost estimate for a key, walking the cold-start fallback
        chain: the exact ``(model, sig, k, g, w)`` key when every
        component is given and has samples; else the same-model merge
        over every signature/depth/width; else the global merge.
        Returns None when the model is empty.  ``q`` defaults to
        ``DCCRG_COST_QUANTILE``; ``q_value`` is that quantile,
        ``p50``/``p95`` always ride along."""
        q = quantile_target() if q is None else min(max(float(q), 0.0), 1.0)
        hist = None
        level = None
        sumsq = 0.0
        if None not in (sig, k, g, w):
            label = key_label(model, sig, k, g, w)
            with self._lock:
                h = self._series.get(label)
                if h is not None and h["count"]:
                    hist = dict(h, buckets=dict(h["buckets"]))
                    sumsq = self._sumsq.get(label, 0.0)
                    level = "exact"
        if hist is None:
            h, sq = self._merged(model)
            if h and h.get("count"):
                hist, sumsq, level = h, sq, "model"
        if hist is None:
            h, sq = self._merged(None)
            if h and h.get("count"):
                hist, sumsq, level = h, sq, "global"
        if hist is None:
            return None
        n = int(hist["count"])
        mean = float(hist["sum"]) / max(n, 1)
        var = max(sumsq / max(n, 1) - mean ** 2, 0.0)
        return CostEstimate(
            p50=_slo_quantile(hist, 0.5),
            p95=_slo_quantile(hist, 0.95),
            q_value=_slo_quantile(hist, q),
            n=n, level=level, mean=mean, std=math.sqrt(var), q=q,
        )


#: the process-wide model the serving write side records into
model = StepCostModel()


def record_dispatch(kind: str, sig: str, k: int, g: int, w: int,
                    dispatch_s: float) -> None:
    """One cohort dispatch's timing into the process-wide model: the
    sample is normalized to per-interior-step seconds
    (``dispatch_s / k``) so estimates compare across depths."""
    model.observe(kind, sig, k, g, w, dispatch_s / max(int(k), 1))


# ------------------------------------------------------------- capacity

class ServiceRateTracker:
    """Per-tenant served-steps rate over a sliding window of
    scheduling-tick records — the write side's arrival/service-rate
    window (the read side re-derives the same rates from ``FleetView``
    bucket-deltas).

    Rates are member-steps per BUSY second, where busy is the full
    scheduling-tick wall (dispatches plus the admission, retirement and
    gauge overhead riding each tick) — a backlog drains at the tick
    rate, not the bare kernel rate, yet idle gaps between bursts must
    not dilute the service rate a queued request's wait is predicted
    against."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = float(window_s)
        # reentrant: _evict re-takes the lock under note()/rate()
        self._lock = threading.RLock()
        self._entries: collections.deque = collections.deque()
        # rolling window totals so rate() is O(1), not a walk of every
        # record in the window per queried tenant per scheduling tick
        self._busy = 0.0
        self._steps = 0.0
        self._tenant_steps: dict = {}

    def _evict(self, now: float) -> None:
        with self._lock:
            edge = now - self.window_s
            while self._entries and self._entries[0][0] < edge:
                _, served, busy_s = self._entries.popleft()
                self._busy -= busy_s
                for t, v in served.items():
                    self._steps -= v
                    left = self._tenant_steps.get(t, 0.0) - v
                    if left <= 0:
                        self._tenant_steps.pop(t, None)
                    else:
                        self._tenant_steps[t] = left
            if not self._entries:
                self._busy = self._steps = 0.0
                self._tenant_steps.clear()

    def note(self, served: dict, busy_s: float, now=None) -> None:
        """Record one scheduling tick: ``served`` maps tenant ->
        member-steps advanced; ``busy_s`` its wall seconds."""
        now = time.perf_counter() if now is None else float(now)
        busy_s = float(busy_s)
        with self._lock:
            self._entries.append((now, dict(served), busy_s))
            self._busy += busy_s
            for t, v in served.items():
                self._steps += v
                self._tenant_steps[t] = self._tenant_steps.get(t, 0.0) + v
            self._evict(now)

    def rate(self, tenant=None, now=None) -> float:
        """Member-steps per busy-second for ``tenant`` (None = whole
        fleet) over the window; 0.0 when no record exists."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            self._evict(now)
            if self._busy <= 0:
                return 0.0
            steps = (self._steps if tenant is None
                     else self._tenant_steps.get(tenant, 0.0))
            return steps / self._busy

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._busy = self._steps = 0.0
            self._tenant_steps.clear()


#: the process-wide tracker ``Cohort.step`` feeds
tracker = ServiceRateTracker()


def predicted_wait(queued_steps: dict, rates=None, now=None) -> dict:
    """Predicted queue-wait seconds per tenant: backlog member-steps
    over the tenant's measured service rate.  ``rates`` is a callable
    ``(tenant | None) -> steps/s`` (default: the process-wide
    :data:`tracker`).  A tenant with no serving history borrows the
    fleet rate scaled by its share of the total backlog — equivalently,
    its requests wait behind the whole FIFO queue.  Tenants with no
    resolvable rate are omitted (the documented cold start)."""
    if rates is None:
        rates = lambda t: tracker.rate(t, now=now)  # noqa: E731
    total = float(sum(queued_steps.values()))
    fleet = None
    out: dict = {}
    for tenant, steps in queued_steps.items():
        if steps <= 0:
            out[tenant] = 0.0
            continue
        r = rates(tenant)
        if r <= 0.0 and total > 0:
            if fleet is None:
                fleet = rates(None)
            r = fleet * steps / total
        if r > 0.0:
            out[tenant] = steps / r
    return out


def queue_wait_estimates(view, model_obj=None) -> dict:
    """Read-side predicted queue-wait per tenant from a live
    :class:`~dccrg_tpu_torch.obs.live.FleetView`: backlog from the
    ``ensemble.queue_depth_steps{tenant}`` gauges, service rates from
    the windowed ``ensemble.steps_served{tenant}`` counter deltas
    (bucket-delta subtraction) scaled to busy time via the windowed
    ``ensemble.step`` phase share when available — else wall-window
    rates (a busy window makes the two agree)."""
    queued: dict = {}
    for label, v in (view.gauge_values("ensemble.queue_depth_steps")
                     or {}).items():
        tenant = parse_label(label).get("tenant", label or "default")
        queued[tenant] = queued.get(tenant, 0) + float(v)
    queued = {t: v for t, v in queued.items() if v > 0}
    if not queued:
        return {}

    def rates(tenant):
        labels = None if tenant is None else {"tenant": tenant}
        return view.rate("ensemble.steps_served", labels)

    return predicted_wait(queued, rates=rates)


# ----------------------------------------------------------- chargeback

def _tenant_of(label: str) -> str:
    return parse_label(label).get("tenant", label or "default")


def chargeback(report: dict) -> dict:
    """Per-tenant ledger from one report snapshot (or a merged one):
    ``{tenant: {device_s, device_share, member_steps, halo_exchanges,
    compile_s, recompiles}}``.  Direct measures: device-seconds
    (``ensemble.device_s{tenant,model}``) and member-steps
    (``ensemble.steps_served{tenant}``).  Attributed measures: halo
    exchanges spread the ``halo.exchanges_per_step{model}`` ratio over
    each tenant's per-model step attribution (its steps split by its
    per-model device-second shares); compile seconds and recompiles
    split the ``compile`` phase total and ``epoch.recompiles`` count by
    overall device-share — the XProf-style discipline of mapping shared
    device/compile time back onto the identities that consumed it."""
    counters = report.get("counters") or {}
    gauges = report.get("gauges") or {}
    phases = report.get("phases") or {}

    device: dict = {}            # tenant -> {model: device_s}
    for label, v in (counters.get("ensemble.device_s") or {}).items():
        kv = parse_label(label)
        t = kv.get("tenant", "default")
        m = kv.get("model", "?")
        device.setdefault(t, {})[m] = device.get(t, {}).get(m, 0.0) + float(v)
    steps: dict = {}
    for label, v in (counters.get("ensemble.steps_served") or {}).items():
        t = _tenant_of(label)
        steps[t] = steps.get(t, 0) + int(v)
    eps: dict = {}               # model -> exchanges per step
    for label, v in (gauges.get("halo.exchanges_per_step") or {}).items():
        eps[parse_label(label).get("model", "?")] = float(v)
    compile_s = float((phases.get("compile") or {}).get("total_s") or 0.0)
    recompiles = sum(
        float(v) for v in (counters.get("epoch.recompiles") or {}).values())

    grand = sum(sum(per.values()) for per in device.values())
    out: dict = {}
    for tenant in sorted(set(device) | set(steps)):
        per_model = device.get(tenant, {})
        dev = sum(per_model.values())
        share = dev / grand if grand > 0 else 0.0
        n_steps = steps.get(tenant, 0)
        exchanges = 0.0
        if n_steps and dev > 0:
            for m, d in per_model.items():
                exchanges += n_steps * (d / dev) * eps.get(m, 0.0)
        out[tenant] = {
            "device_s": dev,
            "device_share": share,
            "member_steps": n_steps,
            "halo_exchanges": exchanges,
            "compile_s": compile_s * share,
            "recompiles": recompiles * share,
        }
    return out


def conservation(report: dict) -> dict:
    """The chargeback conservation check: per-tenant device-seconds
    must sum to the recorded wall×mesh total
    (``ensemble.device_s_total``) within one histogram bucket
    (``2^(1/COST_RESOLUTION)`` ≈ 9% — in practice they agree to float
    addition order).  Returns ``{attributed, total, ratio, ok}``;
    ``ok`` is True when nothing was recorded at all (an empty ledger
    conserves trivially)."""
    counters = report.get("counters") or {}
    attributed = sum(
        float(v) for v in (counters.get("ensemble.device_s") or {}).values())
    total = sum(
        float(v)
        for v in (counters.get("ensemble.device_s_total") or {}).values())
    if total <= 0.0:
        return {"attributed": attributed, "total": total, "ratio": None,
                "ok": attributed == 0.0}
    ratio = attributed / total
    bucket = 2.0 ** (1.0 / COST_RESOLUTION)
    return {"attributed": attributed, "total": total, "ratio": ratio,
            "ok": (1.0 / bucket) <= ratio <= bucket}


# -------------------------------------------------------------- console

def cost_summary(reports, qs=(0.5, 0.95)) -> dict:
    """The fleet cost console's JSON: the step-cost model table (one
    row per key: samples, mean, std, quantiles), the chargeback ledger,
    the conservation check and the latest predicted-wait gauges — all
    from exported report dicts alone (merged across ``reports``)."""
    if isinstance(reports, dict):
        reports = [reports]
    m = StepCostModel.from_reports(reports)
    rows = []
    for label in m.keys():
        kv = parse_label(label)
        est = m.predict(kv.get("model"), sig=kv.get("sig"),
                        k=kv.get("k"), g=kv.get("g"), w=kv.get("w"))
        if est is None:
            continue
        row = {"key": label, "n": est.n, "mean_s": est.mean,
               "std_s": est.std}
        hist = m.series()[label]
        for q in qs:
            row[f"p{round(q * 100):d}_s"] = _slo_quantile(hist, q)
        rows.append(row)
    merged: dict = {"counters": {}, "gauges": {}, "phases": {}}
    for rep in reports:
        for name, series in (rep.get("counters") or {}).items():
            dst = merged["counters"].setdefault(name, {})
            for label, v in series.items():
                dst[label] = dst.get(label, 0) + v
        for name, series in (rep.get("gauges") or {}).items():
            dst = merged["gauges"].setdefault(name, {})
            for label, v in series.items():
                dst[label] = max(dst.get(label, v), v)
        for name, ph in (rep.get("phases") or {}).items():
            dst = merged["phases"].setdefault(
                name, {"total_s": 0.0, "count": 0})
            dst["total_s"] += float(ph.get("total_s") or 0.0)
            dst["count"] += int(ph.get("count") or 0)
    waits = {
        _tenant_of(label): float(v)
        for label, v in (merged["gauges"]
                         .get("cost.predicted_queue_wait_s") or {}).items()
    }
    return {
        "model": rows,
        "chargeback": chargeback(merged),
        "conservation": conservation(merged),
        "predicted_queue_wait_s": waits,
    }
