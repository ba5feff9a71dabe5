"""Supervisor/watchdog: heartbeat-driven failure detection + escalation
(a copy of the JAX package's ``resilience/supervisor.py``; pure host code
over the port's ``obs`` registry, stream and flight recorder).

A supervised worker streams incremental telemetry snapshots
(``obs/stream.py`` JSONL — a heartbeat that survives SIGKILL);
the supervisor *tails* that file and distinguishes three failure shapes
no exit code can report:

* **silence** — the stream stopped ticking (process wedged hard enough
  that even the daemon ticker died, or the host went away);
* **no progress** — lines keep arriving (the ticker thread is alive) but
  the cumulative counters and the worker's ``step`` marker are frozen:
  the step loop is hung (the ``step.hang`` injection site produces
  exactly this);
* **death** — the child process is simply gone (``child_alive``).

Detection feeds an :class:`EscalationLadder` — warn → rescale-down
(degraded mode: fewer devices is better than no progress, counted
``elastic.degraded``) → restart-from-``latest_valid()`` — with every
rung counted (``supervisor.warnings{reason}``,
``supervisor.escalations{action}``) so a soak's telemetry shows the
full escalation history.  A healthy heartbeat resets the ladder.

The supervisor never *performs* the kill/rescale/restart itself — it
returns the decided action and the harness (``resilience/soak.py elastic``,
or a fleet controller) applies it; policy and mechanism stay separate
exactly as in :mod:`~dccrg_tpu_torch.resilience.elastic`.
"""
from __future__ import annotations

import json
import os
import time

from ..obs.flightrec import recorder as flightrec
from ..obs.registry import metrics

__all__ = ["HeartbeatMonitor", "EscalationLadder", "Supervisor"]


class HeartbeatMonitor:
    """Tails one streaming-JSONL heartbeat file.

    ``poll(now)`` reads any new complete lines since the last poll and
    returns ``(status, reason)``: ``("ok", None)`` while beats AND
    progress are fresh, ``("waiting", None)`` before the first beat is
    due, else ``("stalled", reason)`` with reason ``"no-heartbeat"``
    (no new line within ``stall_after_s``) or ``"no-progress"`` (lines
    flowing, counters + ``step`` marker frozen for ``stall_after_s``).

    Progress is any change in the snapshot's cumulative counter totals
    or its ``step`` field (workers put their step index in the stream's
    ``extra``); a truncated trailing line (killed mid-write) is ignored
    until its newline lands, exactly like the stream validator does.
    """

    def __init__(self, path: str, stall_after_s: float = 10.0,
                 now: float | None = None):
        self.path = str(path)
        self.stall_after_s = float(stall_after_s)
        t = time.monotonic() if now is None else float(now)
        self._offset = 0
        self._tail = b""
        self._last_beat = t     # file appearing late counts from start
        self._last_progress = t
        self._progress_key = None
        self.last_snapshot: dict | None = None
        self.beats = 0

    def _read_new_lines(self) -> list:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            buf = self._tail + f.read(size - self._offset)
            self._offset = size
        *lines, self._tail = buf.split(b"\n")
        out = []
        for ln in lines:
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @staticmethod
    def _progress_of(rec: dict):
        totals = tuple(sorted(
            (name, label, v)
            for name, series in (rec.get("counters") or {}).items()
            for label, v in series.items()
        ))
        return (rec.get("step"), totals)

    def poll(self, now: float | None = None):
        now = time.monotonic() if now is None else float(now)
        for rec in self._read_new_lines():
            self.beats += 1
            self.last_snapshot = rec
            self._last_beat = now
            key = self._progress_of(rec)
            if key != self._progress_key:
                self._progress_key = key
                self._last_progress = now
        if self.beats == 0:
            if now - self._last_beat > self.stall_after_s:
                return "stalled", "no-heartbeat"
            return "waiting", None
        if now - self._last_beat > self.stall_after_s:
            return "stalled", "no-heartbeat"
        if now - self._last_progress > self.stall_after_s:
            return "stalled", "no-progress"
        return "ok", None


class EscalationLadder:
    """warn → rescale_down → restart, one rung per :meth:`escalate`.

    ``patience`` unhealthy reports are absorbed per rung before moving
    to the next (default 1: first report warns, second rescales down,
    third restarts, further reports keep returning ``"restart"``).
    ``reset()`` — a healthy heartbeat — drops back to the bottom.
    Every decision is counted: warnings under
    ``supervisor.warnings{reason}``, actions under
    ``supervisor.escalations{action}``, and the degraded rung
    additionally under ``elastic.degraded`` (a rescale the fleet was
    forced into, as opposed to one the policy chose).

    The first rung of an incident also triggers the flight recorder:
    ONE schema-valid postmortem dump per incident — the
    evidence window that is otherwise gone by the time the harness kills
    and relaunches the worker.  A healthy ``reset()`` re-arms the dump
    for the next incident; when no dump directory is configured
    (``DCCRG_FLIGHTREC_DIR`` unset, recorder unarmed) the trigger is a
    counted no-op.
    """

    ACTIONS = ("warn", "rescale_down", "restart")

    def __init__(self, patience: int = 1):
        self.patience = max(int(patience), 1)
        self._level = 0
        self._strikes = 0
        self._dumped = False
        #: path of the incident's postmortem (None until the ladder
        #: fires, or when the recorder is unarmed/disabled)
        self.last_dump = None

    @property
    def level(self) -> int:
        return min(self._level, len(self.ACTIONS) - 1)

    def escalate(self, reason: str, minimum: str = "warn") -> str:
        """One unhealthy report: returns the action for the current
        rung.  ``minimum`` jumps rungs that cannot help (a DEAD child
        gains nothing from a warning — pass ``minimum="rescale_down"``)."""
        floor = self.ACTIONS.index(minimum)
        if self._level < floor:
            self._level, self._strikes = floor, 0
        action = self.ACTIONS[self.level]
        self._strikes += 1
        if not self._dumped:
            # black-box the incident ONCE, at its first rung — by the
            # restart rung the worker (and its evidence) is gone
            self._dumped = True
            flightrec.note("supervisor.escalation", reason=reason,
                           action=action)
            self.last_dump = flightrec.dump(
                reason=f"escalation:{reason}:{action}")
        if self._strikes >= self.patience:
            self._level = min(self._level + 1, len(self.ACTIONS))
            self._strikes = 0
        if action == "warn":
            metrics.inc("supervisor.warnings", reason=reason)
        else:
            if action == "rescale_down":
                metrics.inc("elastic.degraded")
            metrics.inc("supervisor.escalations", action=action)
        return action

    def reset(self) -> None:
        self._level = 0
        self._strikes = 0
        self._dumped = False


class Supervisor:
    """One supervised worker: heartbeat monitor + liveness + ladder.

    ``poll(now)`` returns ``{"status", "reason", "action"}`` where
    ``action`` is None while healthy, else the ladder's decision for
    this tick.  The harness applies the action (kill + relaunch at fewer
    devices for ``rescale_down``, kill + resume from ``latest_valid()``
    for ``restart``) — see ``resilience/soak.py elastic`` for the reference
    harness loop.
    """

    def __init__(self, monitor: HeartbeatMonitor, *, child_alive=None,
                 ladder: EscalationLadder | None = None, alerts=None):
        self.monitor = monitor
        self.ladder = ladder if ladder is not None else EscalationLadder()
        self._child_alive = child_alive
        #: optional alert-engine signal source (``obs/alerts.py``
        #: AlertEngine, or anything with a ``firing()`` name list): a
        #: live child whose SLO rules are firing is unhealthy even
        #: while its heartbeat beats, so the ladder climbs instead of
        #: resetting
        self._alerts = alerts

    def _firing_alerts(self) -> list:
        eng = self._alerts
        if eng is None:
            return []
        try:
            return list(eng.firing())
        except Exception:  # noqa: BLE001 — signals must not kill polling
            return []

    def poll(self, now: float | None = None) -> dict:
        with metrics.phase("supervisor.poll"):
            now = time.monotonic() if now is None else float(now)
            if self._child_alive is not None and not self._child_alive():
                # a corpse cannot act on a warning: enter the ladder at
                # the degraded-rescale rung
                action = self.ladder.escalate(
                    "child-dead", minimum="rescale_down")
                return {"status": "dead", "reason": "child-dead",
                        "action": action}
            status, reason = self.monitor.poll(now)
            if status == "stalled":
                return {"status": status, "reason": reason,
                        "action": self.ladder.escalate(reason)}
            firing = self._firing_alerts()
            if firing:
                # the alert engine already black-boxed the incident; the
                # ladder's own first-rung dump stays armed for the next
                # heartbeat incident and dedups per incident regardless
                reason = f"alert:{firing[0]}"
                return {"status": "degraded", "reason": reason,
                        "action": self.ladder.escalate(reason)}
            if status == "ok":
                self.ladder.reset()
            return {"status": status, "reason": reason, "action": None}
