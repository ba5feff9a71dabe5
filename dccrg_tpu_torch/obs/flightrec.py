"""Black-box flight recorder: an always-on bounded ring of recent
spans, lifecycle events and metric snapshots, dumped as a schema-valid
postmortem file when something goes wrong.

The aggregate registry answers "how much, how often"; the timeline
answers "when" — but both describe a HEALTHY run: when the supervisor
escalates, a verify oracle mismatches, or a soak child is SIGKILLed,
the interesting evidence is the last few seconds before the event, and
by the time anyone looks the process (and its timeline) is gone.  The
recorder is the crash-survivable middle ground:

* a bounded ring (``deque``) of the most RECENT spans — fed every
  completed registry phase via the ``metrics.recorder`` hook (the
  mirror of the timeline hook; note the timeline keeps the OLDEST
  spans when full, the recorder the newest — they answer different
  questions) — plus explicit lifecycle events (:meth:`note`) and an
  in-flight request table (:meth:`begin_request`/:meth:`end_request`)
  the serving front-end maintains;
* :meth:`dump` writes one postmortem JSON (schema
  ``dccrg.flightrec.v1``: ring contents, in-flight requests, a full
  registry snapshot) via temp-file + rename, so a kill mid-dump leaves
  the previous valid file;
* armed mode (:meth:`arm`, or ``DCCRG_FLIGHTREC_DIR`` at import):
  dumps land in a directory, an atexit final dump is registered, and —
  with autodump on — the ring checkpoints itself to
  ``flightrec_<pid>.json`` on recording activity every ``period``
  seconds, which is how a SIGKILLed soak child still leaves a dump
  naming the request it was serving (``tools/soak.py`` asserts this);
* trigger points elsewhere: the resilience supervisor's escalation
  ladder dumps once per incident when it fires, and the ensemble's
  solo-replay oracle dumps on its first mismatch.

Env: ``DCCRG_FLIGHTREC=0`` disables the recorder entirely (every call
an attribute-check no-op); ``DCCRG_FLIGHTREC_CAP`` sizes the rings
(default 512 spans / 512 events); ``DCCRG_FLIGHTREC_DIR`` arms dumping
into that directory at import.  Recording must never raise into the
workload — dump failures are swallowed (and counted when possible).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque

from .registry import metrics

__all__ = [
    "FlightRecorder",
    "recorder",
    "validate_flightrec",
    "SCHEMA",
]

SCHEMA = "dccrg.flightrec.v1"


def _env_enabled() -> bool:
    return os.environ.get("DCCRG_FLIGHTREC", "1").lower() not in (
        "0", "false", "off", "no",
    )


def _env_cap() -> int:
    try:
        return max(int(os.environ.get("DCCRG_FLIGHTREC_CAP", 512)), 8)
    except ValueError:
        return 512


class FlightRecorder:
    """Thread-safe bounded ring + in-flight request table + dumper."""

    def __init__(self, cap: int | None = None, enabled: bool | None = None,
                 registry=None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        cap = _env_cap() if cap is None else max(int(cap), 8)
        self.cap = cap
        self._registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=cap)   # (name, begin_perf, dur, args)
        self._events: deque = deque(maxlen=cap)  # (kind, t_perf, info)
        self._inflight: dict = {}                # id -> info (insertion order)
        self._seen = {"spans": 0, "events": 0}
        # wall-clock anchor for exports (perf_counter is not unix time)
        self._t0_perf = time.perf_counter()
        self._t0_wall = time.time()
        self._dir: str | None = None
        self._autodump = False
        self._period = 1.0
        self._last_auto = 0.0
        self._dump_seq = 0
        self._atexit_registered = False

    # ------------------------------------------------------------ writes

    def add_span(self, name: str, begin: float, duration: float,
                 args: dict | None = None) -> None:
        """Record one completed span (``begin`` in ``perf_counter``
        time) into the ring — the registry feeds every completed phase
        here via the ``metrics.recorder`` hook."""
        if not self.enabled:
            return
        with self._lock:
            self._seen["spans"] += 1
            self._spans.append(
                (str(name), float(begin), max(float(duration), 0.0),
                 dict(args) if args else None)
            )
        self._maybe_autodump()

    def note(self, kind: str, **info) -> None:
        """Record one lifecycle event (request transitions, faults,
        escalations) into the ring."""
        if not self.enabled:
            return
        with self._lock:
            self._seen["events"] += 1
            self._events.append((str(kind), time.perf_counter(), info))
        self._maybe_autodump()

    def begin_request(self, rid, **info) -> None:
        """Track one in-flight unit of work.  The in-flight table is
        NOT a ring: it holds exactly the requests that were being served
        at dump time — the victims a postmortem must name."""
        if not self.enabled:
            return
        with self._lock:
            self._inflight[str(rid)] = {
                "since": time.perf_counter(), **info,
            }

    def end_request(self, rid, **info) -> None:
        """Retire one in-flight unit (also records a ring event when
        extra info — final status, deadline fate — is supplied)."""
        if not self.enabled:
            return
        with self._lock:
            self._inflight.pop(str(rid), None)
        if info:
            self.note("request.done", request=str(rid), **info)

    def mark_unit(self, uid, **info) -> None:
        """Serial-worker convenience (the soak children): retire every
        in-flight unit, track ``uid`` as the one now executing, and tick
        the autodump — so the latest checkpoint always names the step
        that was running when the process was killed."""
        if not self.enabled:
            return
        with self._lock:
            self._inflight.clear()
            self._inflight[str(uid)] = {
                "since": time.perf_counter(), **info,
            }
        self.note("unit", unit=str(uid), **info)

    # ----------------------------------------------------------- arming

    def arm(self, directory: str, period: float = 1.0,
            autodump: bool = True) -> None:
        """Direct dumps into ``directory`` (created if needed), register
        a final atexit dump, and — with ``autodump`` — checkpoint the
        ring on recording activity every ``period`` seconds."""
        os.makedirs(str(directory), exist_ok=True)
        self._dir = str(directory)
        self._period = max(float(period), 0.05)
        self._autodump = bool(autodump)
        self._last_auto = 0.0
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self._atexit_dump)
        if self._autodump:
            self.checkpoint(force=True)

    def disarm(self) -> None:
        self._dir = None
        self._autodump = False

    @property
    def armed_dir(self) -> str | None:
        return self._dir

    def _atexit_dump(self) -> None:
        try:
            if self.enabled and self._dir is not None:
                self.checkpoint(force=True, reason="at-exit")
        except Exception:  # noqa: BLE001 — never fail interpreter exit
            pass

    def _maybe_autodump(self) -> None:
        if not self._autodump or self._dir is None:
            return
        now = time.monotonic()
        if now - self._last_auto >= self._period:
            self._last_auto = now
            self.checkpoint(force=True, reason="checkpoint")

    def checkpoint(self, force: bool = False,
                   reason: str = "checkpoint") -> str | None:
        """Rewrite the rolling per-process dump
        (``flightrec_<pid>.json`` under the armed directory) — the file
        a SIGKILLed worker leaves behind.  Atomic, so a kill mid-write
        preserves the previous checkpoint."""
        if not self.enabled or self._dir is None:
            return None
        if not force:
            now = time.monotonic()
            if now - self._last_auto < self._period:
                return None
            self._last_auto = now
        path = os.path.join(self._dir, f"flightrec_{os.getpid()}.json")
        return self._write(path, reason)

    def dump(self, path: str | None = None, reason: str = "on-demand",
             **extra) -> str | None:
        """Write one uniquely-named postmortem file (armed directory,
        or an explicit ``path``) and return its path.  Unarmed and
        pathless, the dump is skipped (returns None) — trigger seams
        like the escalation ladder call unconditionally and the
        recorder decides whether a black box was requested."""
        if not self.enabled:
            return None
        if path is None:
            if self._dir is None:
                return None
            with self._lock:
                seq = self._dump_seq
                self._dump_seq += 1
            path = os.path.join(
                self._dir, f"flightrec_{os.getpid()}_{seq:03d}.json"
            )
        return self._write(str(path), reason, **extra)

    def _write(self, path: str, reason: str, **extra) -> str | None:
        with metrics.phase("flightrec.dump"):
            try:
                rec = self.record(reason=reason, **extra)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(rec, f, default=float)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except Exception:  # noqa: BLE001 — the black box must never
                return None    # take down the aircraft
        if reason != "checkpoint":
            metrics.inc("flightrec.dumps", reason=reason)
        return path

    # ------------------------------------------------------------- reads

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def in_flight(self) -> list:
        with self._lock:
            return [{"id": rid, **info}
                    for rid, info in self._inflight.items()]

    def record(self, reason: str = "snapshot", **extra) -> dict:
        """The dump payload as a plain dict (see :data:`SCHEMA`).  All
        timestamps are unix seconds (the perf-counter ring stamps are
        rebased on the recorder's wall anchor)."""
        wall = lambda t: round(self._t0_wall + (t - self._t0_perf), 6)
        with self._lock:
            spans = [
                {"name": n, "ts": wall(b), "dur": round(d, 6),
                 **({"args": a} if a else {})}
                for n, b, d, a in self._spans
            ]
            events = [
                {"kind": k, "ts": wall(t), **info}
                for k, t, info in self._events
            ]
            inflight = [
                {"id": rid, **{**info, "since": wall(info["since"])}}
                for rid, info in self._inflight.items()
            ]
            seen = dict(self._seen)
        try:
            snapshot = self._registry.report()
        except Exception:  # noqa: BLE001 — a torn registry still dumps
            snapshot = {}
        return {
            "schema": SCHEMA,
            "reason": str(reason),
            "ts": time.time(),
            "pid": os.getpid(),
            "cap": self.cap,
            "dropped": {
                "spans": max(seen["spans"] - len(spans), 0),
                "events": max(seen["events"] - len(events), 0),
            },
            "spans": spans,
            "events": events,
            "in_flight": inflight,
            "snapshot": snapshot,
            **extra,
        }

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self._inflight.clear()
            self._seen = {"spans": 0, "events": 0}


def validate_flightrec(path: str) -> list:
    """Schema-validate one flight-recorder dump; returns failure strings
    (empty = valid).  The gate ``tools/check_telemetry.py`` and the soak
    tool run it on every postmortem they expect to exist."""
    failures: list = []
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        return [f"dump unreadable: {e}"]
    if not isinstance(rec, dict):
        return ["dump is not an object"]
    if rec.get("schema") != SCHEMA:
        failures.append(f"schema {rec.get('schema')!r} != {SCHEMA!r}")
    for key, typ in (("reason", str), ("ts", (int, float)), ("pid", int),
                     ("spans", list), ("events", list),
                     ("in_flight", list), ("snapshot", dict)):
        if not isinstance(rec.get(key), typ):
            failures.append(f"missing/mistyped key {key!r}")
    for i, sp in enumerate(rec.get("spans") or []):
        if not (isinstance(sp, dict) and isinstance(sp.get("name"), str)
                and isinstance(sp.get("ts"), (int, float))
                and isinstance(sp.get("dur"), (int, float))
                and sp["dur"] >= 0):
            failures.append(f"span {i} malformed: {sp!r}"[:120])
            break
    for i, ev in enumerate(rec.get("events") or []):
        if not (isinstance(ev, dict) and isinstance(ev.get("kind"), str)
                and isinstance(ev.get("ts"), (int, float))):
            failures.append(f"event {i} malformed: {ev!r}"[:120])
            break
    for i, rq in enumerate(rec.get("in_flight") or []):
        if not (isinstance(rq, dict) and "id" in rq):
            failures.append(f"in-flight entry {i} lacks an id: {rq!r}"[:120])
            break
    snap = rec.get("snapshot")
    if isinstance(snap, dict) and snap:
        for key in ("phases", "counters", "gauges", "histograms"):
            if key not in snap:
                failures.append(f"snapshot lacks {key!r}")
    return failures


#: process-wide recorder, fed by every completed registry phase span.
#: ``DCCRG_FLIGHTREC=0`` disables it; ``DCCRG_FLIGHTREC_DIR`` arms
#: autodumping checkpoints there from the moment of import.
recorder = FlightRecorder()

# hook: MetricsRegistry phase completions feed spans here (attached from
# this side so registry.py has no import on the recorder module, exactly
# like the timeline hook)
metrics.recorder = recorder

_dir = os.environ.get("DCCRG_FLIGHTREC_DIR")
if _dir:
    try:
        recorder.arm(_dir)
    except OSError:
        pass
del _dir
