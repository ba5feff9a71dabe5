"""Declarative alerting over live fleet views.

An ``AlertRule`` names a windowed signal (a gauge, a counter rate, a
latency quantile, or the per-tenant deadline-miss rate) and a predicate
over it: ``ceiling`` fires when the value exceeds ``threshold``,
``floor`` when it drops below.  ``for_s`` is the duration the breach
must be sustained before the rule fires (a transient spike never
fires), and ``clear`` is the hysteresis threshold the value must cross
back over before the rule clears (a value oscillating between the fire
and clear thresholds provably never flaps: it stays firing).

The ``AlertEngine`` evaluates rules against any object with the
``FleetView`` read protocol (``gauge_values`` / ``rate`` / ``quantile``
/ ``miss_rates``).  Lifecycle per rule::

    ok --breach--> pending --sustained for_s--> firing --clear--> ok
         ^             |  (breach lapses: back to ok, nothing fired)
         +-------------+

On fire: ``alerts.fired{rule}`` increments, a timeline span lands, and
— reusing the escalation ladder's one-dump-per-incident discipline — an
armed flight recorder dumps ONCE per incident (the firing state itself
is the "dumped" latch; re-entering fire after a clear is a new incident
and dumps again).  On clear: ``alerts.cleared{rule}`` increments and
the incident's duration lands as an ``alert.incident`` span.

Stdlib-only.  A copy of the JAX package's ``obs/alerts.py`` without its
standalone-load fallback.
``DCCRG_ALERTS=0`` disables the default engine, ``DCCRG_ALERT_RULES``
points at a JSON rules file replacing the shipped defaults.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

from .registry import metrics as _metrics
from .flightrec import recorder as _recorder

__all__ = [
    "AlertRule",
    "AlertEngine",
    "alerts_enabled",
    "default_rules",
    "load_rules",
    "rules_from_env",
]

#: rule lifecycle states
OK, PENDING, FIRING = "ok", "pending", "firing"


def alerts_enabled() -> bool:
    """``DCCRG_ALERTS`` master switch (default on)."""
    return os.environ.get("DCCRG_ALERTS", "1").lower() not in (
        "0", "false", "off", "no", "")


class AlertRule:
    """One declarative rule over a windowed fleet signal.

    ``source`` selects how the value is read from the view:

    - ``"gauge"``: latest gauge readings; ``ceiling`` takes the max
      across labels, ``floor`` the min (the worst offender decides).
    - ``"rate"``: windowed counter increase per second.
    - ``"quantile"``: windowed latency quantile (``quantile=`` fraction).
    - ``"miss_rate"``: worst per-tenant windowed deadline-miss rate.

    ``labels`` (a dict) narrows the series; ``clear`` defaults to
    ``threshold`` (no hysteresis).  A view with no data for the series
    yields ``None`` and leaves the rule's state untouched.
    """

    def __init__(self, name, metric=None, *, source="gauge",
                 kind="ceiling", threshold=0.0, clear=None, for_s=0.0,
                 labels=None, quantile=0.99):
        if source not in ("gauge", "rate", "quantile", "miss_rate"):
            raise ValueError(f"unknown alert source: {source!r}")
        if kind not in ("ceiling", "floor"):
            raise ValueError(f"unknown alert kind: {kind!r}")
        self.name = str(name)
        self.metric = metric
        self.source = source
        self.kind = kind
        self.threshold = float(threshold)
        self.clear = float(clear) if clear is not None else float(threshold)
        self.for_s = float(for_s)
        self.labels = dict(labels) if labels else None
        self.quantile = float(quantile)

    def value(self, view):
        """Read the rule's signal from a view; None when absent."""
        if self.source == "gauge":
            vals = [v for v in view.gauge_values(self.metric).values()
                    if v is not None]
            if not vals:
                return None
            return max(vals) if self.kind == "ceiling" else min(vals)
        if self.source == "rate":
            return view.rate(self.metric, self.labels)
        if self.source == "quantile":
            return view.quantile(self.metric, self.quantile, self.labels)
        rates = [rec.get("rate")
                 for tenant, rec in view.miss_rates().items()
                 if rec.get("rate") is not None
                 and (not self.labels
                      or self.labels.get("tenant") in (None, tenant))]
        return max(rates) if rates else None

    def breached(self, value) -> bool:
        return (value > self.threshold if self.kind == "ceiling"
                else value < self.threshold)

    def cleared(self, value) -> bool:
        return (value <= self.clear if self.kind == "ceiling"
                else value >= self.clear)

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "source": self.source, "kind": self.kind,
                "threshold": self.threshold, "clear": self.clear,
                "for_s": self.for_s, "labels": self.labels,
                "quantile": self.quantile}

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        d = dict(d)
        name = d.pop("name")
        metric = d.pop("metric", None)
        return cls(name, metric, **d)


class _RuleState:
    __slots__ = ("status", "since", "fired_at", "fired_perf", "value",
                 "fires", "clears", "dump_path")

    def __init__(self):
        self.status = OK
        self.since = None
        self.fired_at = None
        self.fired_perf = None
        self.value = None
        self.fires = 0
        self.clears = 0
        self.dump_path = None


class AlertEngine:
    """Evaluate rules against successive fleet views.

    ``poll(view)`` advances every rule's state machine and returns the
    transitions that happened this round as ``{"rule", "event",
    "value"}`` dicts (``event`` in ``fired`` / ``cleared``).  The
    engine is a valid supervisor signal source: ``firing()`` lists the
    rule names currently in the firing state.
    """

    def __init__(self, rules=None, registry=None, flight_recorder=None):
        self.rules = list(rules) if rules is not None else default_rules()
        # None -> the process-wide default; False -> explicitly off
        # (tests and standalone consoles evaluate without side effects)
        self._registry = (None if registry is False
                          else registry if registry is not None
                          else _metrics)
        self._flightrec = (None if flight_recorder is False
                           else flight_recorder
                           if flight_recorder is not None else _recorder)
        self._states = {r.name: _RuleState() for r in self.rules}

    def _phase(self):
        reg = self._registry
        if reg is not None and getattr(reg, "enabled", False):
            return reg.phase("alerts.evaluate")
        return contextlib.nullcontext()

    def _count(self, name, rule):
        reg = self._registry
        if reg is not None and getattr(reg, "enabled", False):
            reg.inc(name, rule=rule)

    def _timeline(self):
        return getattr(self._registry, "timeline", None)

    def _fire(self, rule, state, value, now):
        state.status = FIRING
        state.fired_at = now
        state.fired_perf = time.perf_counter()
        state.fires += 1
        self._count("alerts.fired", rule.name)
        tl = self._timeline()
        if tl is not None and getattr(tl, "enabled", False):
            tl.add(f"alert.fired:{rule.name}", time.perf_counter(), 0.0,
                   {"rule": rule.name, "value": value,
                    "threshold": rule.threshold})
        fr = self._flightrec
        if fr is not None:
            # one dump per incident: fire is the only ok/pending->firing
            # edge, so this runs exactly once until the rule clears
            fr.note("alert.fired", rule=rule.name, value=value,
                    threshold=rule.threshold, rule_kind=rule.kind,
                    source=rule.source, metric=rule.metric)
            state.dump_path = fr.dump(reason=f"alert:{rule.name}")

    def _clear(self, rule, state, value, now):
        dur = (time.perf_counter() - state.fired_perf
               if state.fired_perf is not None else 0.0)
        tl = self._timeline()
        if tl is not None and getattr(tl, "enabled", False):
            tl.add(f"alert.incident:{rule.name}",
                   time.perf_counter() - dur, dur,
                   {"rule": rule.name, "cleared_value": value,
                    "duration_s": dur})
        state.status = OK
        state.since = None
        state.fired_at = None
        state.fired_perf = None
        state.clears += 1
        self._count("alerts.cleared", rule.name)

    def poll(self, view, now=None) -> list:
        """Advance every rule against one view; returns transitions."""
        now = time.time() if now is None else float(now)
        out = []
        with self._phase():
            for rule in self.rules:
                state = self._states[rule.name]
                try:
                    value = rule.value(view)
                except (AttributeError, TypeError, KeyError):
                    value = None
                if value is None:
                    continue  # no data: hold state, never fire or clear
                state.value = value
                if state.status == OK:
                    if rule.breached(value):
                        state.status = PENDING
                        state.since = now
                        if now - state.since >= rule.for_s:
                            self._fire(rule, state, value, now)
                            out.append({"rule": rule.name,
                                        "event": "fired", "value": value})
                elif state.status == PENDING:
                    if not rule.breached(value):
                        state.status = OK  # lapsed before for_s: no fire
                        state.since = None
                    elif now - state.since >= rule.for_s:
                        self._fire(rule, state, value, now)
                        out.append({"rule": rule.name,
                                    "event": "fired", "value": value})
                else:  # FIRING: only a full hysteresis crossing clears
                    if rule.cleared(value):
                        self._clear(rule, state, value, now)
                        out.append({"rule": rule.name,
                                    "event": "cleared", "value": value})
        return out

    def firing(self) -> list:
        """Rule names currently in the firing state (sorted)."""
        return sorted(name for name, s in self._states.items()
                      if s.status == FIRING)

    def state(self, name) -> dict:
        s = self._states[name]
        return {"status": s.status, "value": s.value, "fires": s.fires,
                "clears": s.clears, "since": s.since,
                "fired_at": s.fired_at, "dump": s.dump_path}

    def snapshot(self) -> dict:
        """``{rule: state-dict}`` for consoles (`fleet_top`)."""
        return {r.name: self.state(r.name) for r in self.rules}


def default_rules() -> list:
    """The shipped rule set over the serving stack's own series."""
    try:
        queue_target = float(os.environ.get(
            "DCCRG_ELASTIC_QUEUE_TARGET", "8"))
    except ValueError:
        queue_target = 8.0
    try:
        stall = float(os.environ.get("DCCRG_GATEWAY_STALL_S", "10"))
    except ValueError:
        stall = 10.0
    return [
        # worker-lost: a worker heartbeat stream whose
        # ``stream.age_s`` gauge exceeds 3x the gateway stall budget is
        # a dead/wedged worker — the same signal the gateway's
        # per-worker HeartbeatMonitor escalates on, surfaced through
        # the alert plane so a Supervisor wired with this engine (its
        # ``alerts=`` hook) climbs the ladder even when only the
        # merged fleet view sees the silence
        AlertRule("worker-lost", "stream.age_s",
                  source="gauge", kind="ceiling",
                  threshold=3.0 * stall, clear=stall, for_s=0.0),
        AlertRule("deadline-miss-rate", "ensemble.deadline_miss",
                  source="miss_rate", kind="ceiling",
                  threshold=0.05, clear=0.01, for_s=0.0),
        AlertRule("queue-depth", "ensemble.queue_depth",
                  source="gauge", kind="ceiling",
                  threshold=2.0 * queue_target, clear=queue_target,
                  for_s=5.0),
        AlertRule("halo-exchanges-per-step", "halo.exchanges_per_step",
                  source="gauge", kind="ceiling",
                  threshold=2.0, clear=1.5, for_s=0.0),
        AlertRule("overlap-fraction", "overlap.fraction",
                  source="gauge", kind="floor",
                  threshold=0.10, clear=0.15, for_s=5.0),
    ]


def load_rules(path) -> list:
    """Rules from a JSON file: a list of ``AlertRule.to_dict`` objects
    (or ``{"rules": [...]}``)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("rules") or []
    return [AlertRule.from_dict(d) for d in data]


def rules_from_env() -> list:
    """``DCCRG_ALERT_RULES`` file if set, else the shipped defaults."""
    path = os.environ.get("DCCRG_ALERT_RULES")
    if path:
        return load_rules(path)
    return default_rules()
