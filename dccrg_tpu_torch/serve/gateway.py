"""Fault-tolerant fleet gateway: durable submissions, worker-loss
redispatch, and enforced admission control (a port of the JAX package's
``serve/gateway.py``; the journal's on-disk format is that module's, so a
journal written by either package replays in the other).

One process serving alone makes a worker crash a world crash.  The gateway
splits the serving stack into per-worker failure domains the way
production stacks survive machine loss:

* **Crash-durable submission journal** (:class:`SubmissionJournal`): an
  append-only JSONL WAL — every record carries a CRC32 over its
  canonical JSON — plus tmp+rename snapshot checkpoints reusing
  ``io/checkpoint.py``'s torn-write discipline (``os.replace`` +
  directory fsync).  A gateway SIGKILL at ANY byte boundary replays to
  the exact accepted/assigned/retired state: complete records are
  authoritative, the torn tail (a record cut mid-write, or any record
  whose CRC disagrees) is counted under ``gateway.journal_torn`` and
  discarded — counted, never fatal.  Every open of an existing journal
  counts ``gateway.journal_replays``.

* **Supervised workers**: each worker process runs the
  ``serve/ensemble.py`` scheduler loop on its own slots of the card and
  heartbeats through the existing streaming JSONL
  (``resilience/supervisor.py::HeartbeatMonitor`` tails it — the
  worker's ``step`` marker is the progress signal).  On silence, wedge
  or death the :class:`~dccrg_tpu_torch.resilience.supervisor.EscalationLadder`
  marks the worker lost (one flight-recorder dump per incident, naming
  the worker) and the gateway **redispatches its in-flight scenarios**
  to surviving workers from the journaled step watermark: stepping is
  at-least-once, retirement is exactly-once (dedupe on scenario id —
  a duplicate retire report from a zombie worker is counted under
  ``gateway.retire_duplicates`` and dropped).  Bit-identity survives
  redispatch because members park their exact state bytes at every
  watermark (atomic tmp+rename ``.npz``) and stepping is deterministic
  — the solo-replay oracle byte-compares redispatched members against
  an uninterrupted reference in ``python -m
  dccrg_tpu_torch.resilience.soak fleet``.

* **Warm replacements**: routing keys on ``ShapeSignature.label()``
  (stable across processes) and every worker shares one kernel build
  directory (``DCCRG_COMPILE_CACHE_DIR``, else the package's), so a
  replacement worker serves the lost worker's cohorts with
  ``epoch.recompiles == 0``.

* **Enforced admission**: the
  queue is bounded (``DCCRG_GATEWAY_QUEUE_MAX``) and a submission whose
  tenant's predicted queue wait (``obs/cost.py::predicted_wait`` over a
  gateway-local service-rate tracker fed by worker watermark progress)
  blows its SLO budget — the scenario's own deadline slack, or the
  ``DCCRG_SLO_QUEUE_S`` tenant budget — is REJECTED with a reason
  (``gateway.rejected{reason}``), not parked into an unbounded queue.
  ``DCCRG_GATEWAY_ADMISSION=0`` turns enforcement off (the A/B the
  starvation proof runs).

* **Graceful drain**: SIGTERM to a worker stops its admission, parks
  in-flight members at the next chunk boundary and hands them back;
  the gateway reassigns the parked scenarios to surviving workers.

Wire protocol (all JSONL, all torn-tail tolerant): the gateway appends
assignments to each worker's ``inbox.jsonl``; workers append
``started`` / ``watermark`` / ``retired`` / ``handback`` records to
their ``outbox.jsonl`` and heartbeat via ``worker.stream.jsonl``.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import zlib

from ..io.checkpoint import _fsync_dir
from ..obs import cost as obs_cost
from ..obs.flightrec import recorder as flightrec
from ..obs.registry import metrics
from ..resilience.supervisor import (
    EscalationLadder,
    HeartbeatMonitor,
    Supervisor,
)

__all__ = [
    "SubmissionJournal",
    "Gateway",
    "WorkerHandle",
    "admission_enabled",
    "gateway_queue_max",
]


# ------------------------------------------------------------ env knobs

def admission_enabled() -> bool:
    """``DCCRG_GATEWAY_ADMISSION`` master switch (default on): off, the
    gateway accepts anything the queue bound allows — the A/B mode the
    starvation proof measures against."""
    return os.environ.get("DCCRG_GATEWAY_ADMISSION", "1").lower() not in (
        "0", "false", "off", "no", "")


def gateway_queue_max() -> int:
    """``DCCRG_GATEWAY_QUEUE_MAX``: accepted-but-unretired scenario
    bound (default 256) — the hard backpressure edge."""
    try:
        return max(1, int(os.environ.get("DCCRG_GATEWAY_QUEUE_MAX", "256")))
    except ValueError:
        return 256


def _park_every() -> int:
    """``DCCRG_GATEWAY_PARK_EVERY``: interior steps per watermark/park
    chunk (default 4).  Smaller = finer redispatch resume points at
    more parking I/O."""
    try:
        return max(1, int(os.environ.get("DCCRG_GATEWAY_PARK_EVERY", "4")))
    except ValueError:
        return 4


def _stall_after_s() -> float:
    """``DCCRG_GATEWAY_STALL_S``: heartbeat silence/no-progress seconds
    before the watchdog escalates a worker (default 10)."""
    try:
        return float(os.environ.get("DCCRG_GATEWAY_STALL_S", "10"))
    except ValueError:
        return 10.0


# ---------------------------------------------------------- the journal

def _canon(payload: dict) -> bytes:
    """Canonical bytes of one journal payload — the CRC domain.  Key
    order is fixed by ``sort_keys`` so the CRC is byte-stable across
    processes and replays."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


class SubmissionJournal:
    """Append-only JSONL WAL with per-record CRC and tmp+rename
    snapshot checkpoints.

    Record format — one JSON object per line::

        {"crc": <crc32 of the canonical payload>, ...payload}

    where the payload carries ``ev`` (``accepted`` / ``rejected`` /
    ``assigned`` / ``watermark`` / ``retired`` / ``redispatched`` /
    ``worker_lost``) and its event fields.  :meth:`replay` reconstructs
    the exact accepted/assigned/retired state from the longest clean
    prefix: the FIRST torn or CRC-mismatched record ends the readable
    prefix (a tear is counted under ``gateway.journal_torn``, never
    fatal — exactly ``test_checkpoint_hardening``'s contract for the
    binary format).

    :meth:`checkpoint` compacts the WAL into a snapshot file written
    tmp + ``os.replace`` + directory fsync (``io/checkpoint.py``'s
    torn-write discipline), then truncates the WAL — a kill between
    those two steps only replays already-snapshotted records, which is
    idempotent by construction (every apply is last-write-wins or
    set-insert).
    """

    SNAPSHOT_SUFFIX = ".snap.json"

    def __init__(self, path: str):
        self.path = str(path)
        self.snap_path = self.path + self.SNAPSHOT_SUFFIX
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        #: sid -> submission record (spec, tenant, deadline_s, ...)
        self.accepted: dict = {}
        #: sid -> worker id (latest assignment wins)
        self.assigned: dict = {}
        #: sid -> last journaled step watermark (and park path)
        self.watermark: dict = {}
        #: sids retired exactly once (the dedupe set)
        self.retired: set = set()
        #: sid -> reject reason (durable, so a replayed gateway never
        #: re-admits what admission control already refused)
        self.rejected: dict = {}
        #: tears observed across the lifetime of this journal object
        self.torn = 0
        existed = os.path.exists(self.path) or os.path.exists(self.snap_path)
        if existed:
            self.replay()
        self._f = open(self.path, "a")

    # ------------------------------------------------------------ write

    def append(self, ev: str, **fields) -> dict:
        """Durably append one event record and apply it to the in-memory
        state.  The line is flushed + fsynced before apply, so the
        in-memory state never runs ahead of what a crash would replay."""
        payload = {"ev": str(ev), **fields}
        rec = {"crc": zlib.crc32(_canon(payload)), **payload}
        self._f.write(json.dumps(rec, sort_keys=True,
                                 separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._apply(payload)
        return payload

    def _apply(self, p: dict) -> None:
        ev = p.get("ev")
        sid = p.get("sid")
        if ev == "accepted":
            self.accepted[sid] = {k: v for k, v in p.items()
                                  if k not in ("ev",)}
        elif ev == "rejected":
            self.rejected[sid] = p.get("reason", "unknown")
        elif ev in ("assigned", "redispatched"):
            self.assigned[sid] = p.get("worker")
        elif ev == "watermark":
            cur = self.watermark.get(sid, {}).get("step", -1)
            if int(p.get("step", 0)) >= cur:
                self.watermark[sid] = {"step": int(p.get("step", 0)),
                                       "park": p.get("park")}
        elif ev == "retired":
            self.retired.add(sid)
        elif ev == "worker_lost":
            pass  # informational: the paired redispatched records act

    # ------------------------------------------------------------- read

    def replay(self) -> int:
        """Rebuild state from snapshot + WAL; returns the number of WAL
        records applied.  Counted under ``gateway.journal_replays``;
        each torn/corrupt record ends the prefix and counts
        ``gateway.journal_torn``."""
        self.accepted, self.assigned = {}, {}
        self.watermark, self.retired, self.rejected = {}, set(), {}
        # snapshot first (itself CRC-guarded; a torn snapshot — only
        # possible on filesystems without atomic replace — is a tear)
        if os.path.exists(self.snap_path):
            try:
                with open(self.snap_path) as f:
                    snap = json.load(f)
                body = snap.get("state") or {}
                if zlib.crc32(_canon(body)) != snap.get("crc"):
                    raise ValueError("snapshot CRC mismatch")
                self.accepted = dict(body.get("accepted") or {})
                self.assigned = dict(body.get("assigned") or {})
                self.watermark = dict(body.get("watermark") or {})
                self.retired = set(body.get("retired") or [])
                self.rejected = dict(body.get("rejected") or {})
            except (OSError, ValueError):
                self.torn += 1
                metrics.inc("gateway.journal_torn", section="snapshot")
        applied = 0
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = b""
        if raw:
            lines = raw.split(b"\n")
            torn_tail = bool(lines and lines[-1] != b"")
            body_lines = lines[:-1] if torn_tail else lines
            tear = torn_tail
            for ln in body_lines:
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                    payload = {k: v for k, v in rec.items() if k != "crc"}
                    if zlib.crc32(_canon(payload)) != rec.get("crc"):
                        raise ValueError("record CRC mismatch")
                except (ValueError, TypeError):
                    # first bad record ends the authoritative prefix —
                    # anything after it may be a torn-then-reused region
                    tear = True
                    break
                self._apply(payload)
                applied += 1
            if tear:
                self.torn += 1
                metrics.inc("gateway.journal_torn", section="wal")
        metrics.inc("gateway.journal_replays")
        return applied

    # ------------------------------------------------------ checkpoint

    def checkpoint(self) -> None:
        """Compact: snapshot the full state tmp+rename (+ dir fsync),
        then truncate the WAL.  Crash-safe at every byte boundary."""
        body = {
            "accepted": self.accepted,
            "assigned": self.assigned,
            "watermark": self.watermark,
            "retired": sorted(self.retired),
            "rejected": self.rejected,
        }
        snap = {"crc": zlib.crc32(_canon(body)), "state": body}
        tmp = self.snap_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        _fsync_dir(self.snap_path)
        self._f.close()
        self._f = open(self.path, "w")  # truncate: snapshot holds it all
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    # ------------------------------------------------------- derived

    def in_flight(self, worker=None) -> list:
        """Accepted, assigned, unretired sids (optionally one worker's)
        — the redispatch set when that worker is lost."""
        out = []
        for sid in self.accepted:
            if sid in self.retired:
                continue
            w = self.assigned.get(sid)
            if w is None:
                continue
            if worker is None or w == worker:
                out.append(sid)
        return out

    def backlog(self) -> list:
        """Accepted, unassigned, unretired sids (admission order)."""
        return [sid for sid in self.accepted
                if sid not in self.retired
                and sid not in self.assigned]


# --------------------------------------------------------- JSONL tails

class _JsonlTail:
    """Offset-tracking JSONL reader tolerating torn trailing lines —
    the same carry-buffer discipline ``HeartbeatMonitor`` uses, shared
    by the gateway's outbox readers and the worker's inbox reader."""

    def __init__(self, path: str):
        self.path = str(path)
        self._offset = 0
        self._tail = b""

    def poll(self) -> list:
        """New complete records since the last poll."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        self._offset += len(chunk)
        data = self._tail + chunk
        lines = data.split(b"\n")
        self._tail = lines.pop()  # b"" when data ends in newline
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


def _append_jsonl(path: str, rec: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True,
                           separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())


# ------------------------------------------------------------- workers

class WorkerHandle:
    """One supervised worker process and its wire files."""

    def __init__(self, wid: str, workdir: str, n_devices: int,
                 env_extra: dict | None = None, spawn=None,
                 device: str = "cuda"):
        self.wid = str(wid)
        self.workdir = str(workdir)
        self.n_devices = int(n_devices)
        #: where the worker's grids live: ``cuda`` (the card) or ``cpu``
        self.device = str(device)
        self.env_extra = dict(env_extra or {})
        self.inbox = os.path.join(self.workdir, "inbox.jsonl")
        self.outbox = os.path.join(self.workdir, "outbox.jsonl")
        self.stream = os.path.join(self.workdir, "worker.stream.jsonl")
        self.proc = None
        self.lost = False
        self.generation = 0
        self._outbox_tail = _JsonlTail(self.outbox)
        self._spawn = spawn or self._spawn_subprocess
        os.makedirs(self.workdir, exist_ok=True)

    # -------------------------------------------------------- lifecycle

    def _spawn_subprocess(self):
        """Launch ``serve/worker.py`` as a child with its grids on
        ``n_devices`` slots of ``device`` (slots of the one card, not
        devices)."""
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env.update(self.env_extra)
        log = open(os.path.join(self.workdir,
                                f"worker_{self.generation}.log"), "a")
        return subprocess.Popen(
            [sys.executable, "-m", "dccrg_tpu_torch.serve.worker",
             "--workdir", self.workdir, "--worker-id", self.wid,
             "--n-devices", str(self.n_devices), "--device", self.device],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
        )

    def start(self) -> None:
        self.generation += 1
        # a fresh incarnation first reaps any straggler a SIGKILLed
        # gateway left behind: an orphaned worker appending to the
        # wires below AFTER they are truncated would interleave stale
        # records into the new incarnation's streams
        pid_path = os.path.join(self.workdir, "worker.pid")
        try:
            with open(pid_path) as f:
                stale = int(f.read().strip())
            os.kill(stale, signal.SIGKILL)
        except (OSError, ValueError):
            pass
        # fresh wires per incarnation: a replacement must not inherit
        # the dead worker's heartbeat as "progress", re-run assignments
        # the gateway already redispatched elsewhere, or replay its
        # outbox from an offset the tail has already consumed
        for path in (self.stream, self.inbox, self.outbox, pid_path):
            try:
                os.unlink(path)
            except OSError:
                pass
        self._outbox_tail = _JsonlTail(self.outbox)
        self.proc = self._spawn()
        pid = getattr(self.proc, "pid", None)
        if pid is not None:
            try:
                with open(pid_path, "w") as f:
                    f.write(str(pid))
            except OSError:
                pass
        self.lost = False
        self.monitor = HeartbeatMonitor(self.stream,
                                        stall_after_s=_stall_after_s())
        self.supervisor = Supervisor(
            self.monitor,
            child_alive=self.alive,
            ladder=EscalationLadder(patience=1),
        )

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=10)
            except OSError:
                pass

    def terminate(self) -> None:
        """SIGTERM — the worker's graceful-drain signal."""
        if self.proc is not None:
            try:
                self.proc.terminate()
            except OSError:
                pass

    # ------------------------------------------------------------ wires

    def assign(self, rec: dict) -> None:
        _append_jsonl(self.inbox, rec)

    def outbox_records(self) -> list:
        return self._outbox_tail.poll()


# ------------------------------------------------------------- gateway

class Gateway:
    """The fleet front door: durable submissions, routing, redispatch,
    exactly-once retirement, enforced admission.

    The gateway owns no torch state — it is a control plane over the
    journal, the worker wires and the supervisors.  ``tick()`` is the
    whole event loop body (poll outboxes → poll supervisors →
    redispatch → assign backlog); ``run_until_drained`` drives it for
    batch workloads (the soak, the telemetry probe)."""

    def __init__(self, journal_path: str, workers: list,
                 rates=None, now=None, wall=None):
        self.journal = SubmissionJournal(journal_path)
        self.workers = {w.wid: w for w in workers}
        #: gateway-local service-rate window fed by watermark progress
        self.tracker = obs_cost.ServiceRateTracker()
        self._rates = rates  # test seam: (tenant|None) -> steps/s
        self._now = now      # test seam: injected clock
        #: test seam: the wall clock of accept times and deadline verdicts
        self._wall = time.time if wall is None else wall
        self._last_wm: dict = {}   # sid -> last seen watermark step
        self.redispatches: list = []
        self._affinity: dict = {}  # sig label -> wid of last assignment
        # recover: a fresh gateway incarnation owns fresh worker
        # incarnations with truncated inboxes, so every journaled
        # assignment goes back to the backlog and re-routes from its
        # watermark — at-least-once stepping, exactly-once retirement
        # (the retired set survives replay and dedupes re-executions)
        self.journal.assigned.clear()

    # -------------------------------------------------------- admission

    def _clock(self) -> float:
        return time.perf_counter() if self._now is None else self._now()

    def _queued_steps(self) -> dict:
        """Backlog member-steps per tenant — accepted work not yet
        retired (assigned in-flight counts too: a new submission waits
        behind everything the fleet still owes)."""
        out: dict = {}
        for sid, rec in self.journal.accepted.items():
            if sid in self.journal.retired:
                continue
            done = self.journal.watermark.get(sid, {}).get("step", 0)
            left = max(0, int(rec.get("steps", 0)) - int(done))
            t = rec.get("tenant", "default")
            out[t] = out.get(t, 0) + left
        return out

    def predicted_wait(self, tenant: str, extra_steps: int = 0) -> float:
        """Predicted queue wait for one tenant over the fleet's
        measured service rate (0.0 when the rate window is cold).
        ``extra_steps`` adds a not-yet-accepted submission's own work
        to the tenant's backlog — an admission decision prices the
        queue as it would be WITH the newcomer in it."""
        rates = self._rates
        if rates is None:
            rates = lambda t: self.tracker.rate(t)
        queued = self._queued_steps()
        if extra_steps:
            queued[tenant] = queued.get(tenant, 0) + int(extra_steps)
        waits = obs_cost.predicted_wait(queued, rates=rates)
        return float(waits.get(tenant, 0.0))

    def submit(self, spec: dict):
        """Admit or reject one submission — the ENFORCED edge.

        ``spec`` must carry ``sid``, ``model``, ``steps``; optional
        ``tenant``, ``deadline_s`` (relative seconds of slack),
        ``seed`` and model params are passed through to the worker.
        Returns ``(accepted: bool, reason: str | None)``; the decision
        is journaled either way, so a replayed gateway never re-decides
        a submission it already answered."""
        sid = str(spec["sid"])
        if sid in self.journal.accepted:
            return True, None       # durable idempotence under replay
        if sid in self.journal.rejected:
            return False, self.journal.rejected[sid]
        tenant = spec.get("tenant", "default")
        reason = None
        pending = len([s for s in self.journal.accepted
                       if s not in self.journal.retired])
        if pending >= gateway_queue_max():
            reason = "queue-full"
        elif admission_enabled():
            wait = self.predicted_wait(
                tenant, extra_steps=int(spec.get("steps", 0)))
            budget = None
            if spec.get("deadline_s") is not None:
                budget = float(spec["deadline_s"])
            else:
                env = os.environ.get("DCCRG_SLO_QUEUE_S")
                if env:
                    try:
                        budget = float(env)
                    except ValueError:
                        budget = None
            if budget is not None and wait > budget:
                reason = "predicted-late"
        if reason is not None:
            self.journal.append("rejected", sid=sid, tenant=tenant,
                                reason=reason)
            metrics.inc("gateway.rejected", reason=reason)
            flightrec.note("gateway.rejected", sid=sid, tenant=tenant,
                           reason=reason)
            return False, reason
        self.journal.append("accepted", sid=sid, t_accept=self._wall(),
                            **{k: v for k, v in spec.items()
                               if k != "sid"})
        metrics.inc("gateway.accepted", tenant=tenant)
        flightrec.begin_request(f"gw/{sid}", tenant=tenant,
                                status="accepted",
                                steps=spec.get("steps"))
        return True, None

    # ---------------------------------------------------------- routing

    def _live_workers(self) -> list:
        return [w for w in self.workers.values()
                if not w.lost and w.alive()]

    def _load(self, w: WorkerHandle) -> int:
        return len(self.journal.in_flight(w.wid))

    def _route(self, spec: dict):
        """Pick a worker: signature-affinity first (the worker already
        holding this ``ShapeSignature.label()``'s compiled bodies),
        least-loaded among the live fleet otherwise."""
        live = self._live_workers()
        if not live:
            return None
        sig = spec.get("sig")
        pref = self._affinity.get(sig) if sig else None
        if pref is not None:
            w = self.workers.get(pref)
            if w is not None and not w.lost and w.alive():
                # affinity holds only while the preferred worker is not
                # overloaded relative to the least-loaded alternative
                least = min(self._load(x) for x in live)
                if self._load(w) <= least + 1:
                    return w
        w = min(live, key=lambda x: (self._load(x), x.wid))
        if sig:
            self._affinity[sig] = w.wid
        return w

    def assign_backlog(self) -> int:
        """Route accepted-but-unassigned scenarios to live workers."""
        n = 0
        for sid in self.journal.backlog():
            rec = self.journal.accepted[sid]
            w = self._route(rec)
            if w is None:
                break
            wm = self.journal.watermark.get(sid, {})
            assignment = {"sid": sid, **rec,
                          "resume_step": wm.get("step", 0),
                          "park": wm.get("park")}
            self.journal.append("assigned", sid=sid, worker=w.wid)
            w.assign(assignment)
            n += 1
        return n

    # -------------------------------------------------------- outboxes

    def poll_outboxes(self) -> None:
        """Apply worker progress: watermarks feed the journal AND the
        service-rate window; retire reports retire EXACTLY ONCE."""
        for w in self.workers.values():
            for rec in w.outbox_records():
                ev = rec.get("ev")
                sid = str(rec.get("sid"))
                if ev == "started":
                    # the worker reports the grid's REAL signature
                    # label: future same-signature routing prefers this
                    # worker (its compiled cohort bodies are resident)
                    sig = rec.get("sig")
                    if sig:
                        self._affinity[sig] = w.wid
                        if sid in self.journal.accepted:
                            self.journal.accepted[sid]["sig"] = sig
                elif ev == "watermark":
                    step = int(rec.get("step", 0))
                    prev = self._last_wm.get(sid, 0)
                    if step > prev:
                        tenant = (self.journal.accepted.get(sid) or
                                  {}).get("tenant", "default")
                        self.tracker.note(
                            {tenant: step - prev},
                            float(rec.get("busy_s", 0.0)))
                        self._last_wm[sid] = step
                    self.journal.append("watermark", sid=sid, step=step,
                                        park=rec.get("park"))
                elif ev == "retired":
                    if sid in self.journal.retired:
                        # zombie/redispatch duplicate: at-least-once
                        # stepping, exactly-once retirement
                        metrics.inc("gateway.retire_duplicates")
                        continue
                    # the final chunk (watermark -> retire) also feeds
                    # the rate window — a scenario shorter than one
                    # park chunk would otherwise never arm admission
                    step = int(rec.get("step", 0))
                    prev = self._last_wm.get(sid, 0)
                    if step > prev and rec.get("busy_s") is not None:
                        t = (self.journal.accepted.get(sid) or
                             {}).get("tenant", "default")
                        self.tracker.note({t: step - prev},
                                          float(rec.get("busy_s", 0.0)))
                        self._last_wm[sid] = step
                    self.journal.append("retired", sid=sid,
                                        worker=w.wid,
                                        result=rec.get("result"))
                    sub = self.journal.accepted.get(sid) or {}
                    tenant = sub.get("tenant", "default")
                    metrics.inc("gateway.retired", tenant=tenant)
                    # the gateway-level SLO verdict: wall e2e from the
                    # journaled accept time vs the submission's own
                    # deadline budget — what the starvation A/B reads
                    dl, t0 = sub.get("deadline_s"), sub.get("t_accept")
                    if dl is not None and t0 is not None:
                        late = self._wall() - float(t0) > float(dl)
                        metrics.inc("gateway.deadline_miss"
                                    if late else "gateway.deadline_ok",
                                    tenant=tenant)
                    flightrec.note("gateway.retired", sid=sid,
                                   worker=w.wid)
                elif ev == "handback":
                    # graceful drain: back to the backlog, resumable
                    # from the parked watermark
                    if sid in self.journal.assigned:
                        del self.journal.assigned[sid]
                    if rec.get("park") is not None:
                        self.journal.append(
                            "watermark", sid=sid,
                            step=int(rec.get("step", 0)),
                            park=rec.get("park"))

    # ------------------------------------------------------ supervision

    def poll_supervisors(self) -> list:
        """Advance every worker's watchdog; returns the wids newly
        marked lost this poll (their in-flight work is redispatched).

        Liveness and heartbeat are checked against the monitor directly
        (not ``Supervisor.poll``, whose dead-child branch climbs the
        ladder — and fires its one-per-incident dump — before the
        gateway could say WHICH worker died): the victim is named via
        ``flightrec.note`` first, then the ladder's first rung dumps,
        so the postmortem carries the worker id."""
        newly_lost = []
        for w in self.workers.values():
            if w.lost or w.proc is None:
                continue
            now = self._now() if self._now else time.monotonic()
            if w.alive():
                status, reason = w.supervisor.monitor.poll(now)
                if status != "stalled":
                    if status == "ok":
                        w.supervisor.ladder.reset()
                    continue
            else:
                reason = "child-dead"
            flightrec.note("worker.lost", worker=w.wid, reason=reason,
                           generation=w.generation,
                           in_flight=self.journal.in_flight(w.wid))
            w.supervisor.ladder.escalate(
                f"worker-lost:{w.wid}", minimum="rescale_down")
            w.lost = True
            w.kill()
            metrics.inc("gateway.worker_lost", worker=w.wid)
            newly_lost.append(w.wid)
        return newly_lost

    def redispatch(self, wid: str) -> int:
        """Reassign a lost worker's in-flight scenarios to survivors
        from their journaled watermarks."""
        moved = 0
        for sid in self.journal.in_flight(wid):
            rec = self.journal.accepted[sid]
            w = self._route(rec)
            if w is None or w.wid == wid:
                # no survivor: back to the backlog for the replacement
                del self.journal.assigned[sid]
                continue
            wm = self.journal.watermark.get(sid, {})
            self.journal.append("redispatched", sid=sid, worker=w.wid,
                                from_worker=wid,
                                step=wm.get("step", 0))
            metrics.inc("gateway.redispatched", worker=wid)
            self.redispatches.append(
                {"sid": sid, "from": wid, "to": w.wid,
                 "step": wm.get("step", 0)})
            w.assign({"sid": sid, **rec,
                      "resume_step": wm.get("step", 0),
                      "park": wm.get("park")})
            moved += 1
        metrics.gauge("gateway.redispatch_events", len(self.redispatches))
        return moved

    # -------------------------------------------------------- the loop

    def tick(self, restart_lost: bool = True) -> dict:
        """One event-loop pass.  With ``restart_lost`` a lost worker is
        relaunched warm (same workdir, same slots, shared kernel
        cache) after its in-flight work has been redispatched."""
        self.poll_outboxes()
        for wid in self.poll_supervisors():
            self.redispatch(wid)
            if restart_lost:
                self.workers[wid].start()
        assigned = self.assign_backlog()
        if metrics.enabled:
            for w in self.workers.values():
                metrics.gauge("gateway.assigned",
                              self._load(w), worker=w.wid)
            metrics.gauge(
                "gateway.backlog", len(self.journal.backlog()))
        return {
            "assigned": assigned,
            "outstanding": len([s for s in self.journal.accepted
                                if s not in self.journal.retired]),
        }

    def run_until_drained(self, timeout_s: float = 600.0,
                          poll_s: float = 0.1,
                          restart_lost: bool = True,
                          checkpoint_every: int = 50) -> bool:
        """Drive ``tick`` until every accepted scenario has retired (or
        the timeout lapses); snapshots the journal periodically."""
        t0 = time.monotonic()
        n = 0
        while True:
            st = self.tick(restart_lost=restart_lost)
            n += 1
            if n % max(1, checkpoint_every) == 0:
                self.journal.checkpoint()
            if st["outstanding"] == 0:
                self.journal.checkpoint()
                return True
            if time.monotonic() - t0 > timeout_s:
                return False
            time.sleep(poll_s)

    # -------------------------------------------------------- shutdown

    def drain(self, timeout_s: float = 60.0) -> None:
        """SIGTERM every worker and collect their handbacks."""
        for w in self.workers.values():
            w.terminate()
        t0 = time.monotonic()
        while any(w.alive() for w in self.workers.values()):
            self.poll_outboxes()
            if time.monotonic() - t0 > timeout_s:
                break
            time.sleep(0.05)
        self.poll_outboxes()
        self.journal.checkpoint()

    def close(self) -> None:
        for w in self.workers.values():
            w.kill()
        self.journal.close()
