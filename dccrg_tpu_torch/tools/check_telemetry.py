"""Telemetry gate of the port: run a small advection workload and verify
the observability plane end to end (the JAX package's
``tools/check_telemetry.py`` on ``dccrg_tpu_torch``).

    python -m dccrg_tpu_torch.tools.check_telemetry --out DIR/telemetry.json
    python -m dccrg_tpu_torch.tools.check_telemetry --device cpu --out ...

Checks (exit 1 on any failure; every probe collects failure strings and
none is swallowed):

* every instrumented phase fires (``REQUIRED_PHASES``), the counters in
  ``REQUIRED_NONZERO_COUNTERS`` carry values and the histograms in
  ``REQUIRED_HISTOGRAMS`` samples;
* the report exports to ``--out`` and round-trips through ``json.load``;
  the streaming exporter leaves a schema-valid JSONL file beside it
  (``<out>.stream.jsonl``) and the event timeline a valid Chrome trace
  (``<out>.trace.json``), checked by :func:`validate_stream` and
  :func:`validate_chrome_trace` (also standalone: ``--validate-stream``,
  ``--validate-trace``, ``--validate-merged-trace``);
* the probes, in the JAX gate's order: a checkpoint round trip; a forced
  injection round (a bit-flipped lineage generation skipped on its CRC,
  an injected ``p2p.recv`` fault retried); a churn cycle pair (the second
  same-signature cycle compiles nothing); the halo backend
  (``DCCRG_HALO_BACKEND=pallas``, kernel B9 on the card and its twin on
  the CPU, with ``DCCRG_HALO_VERIFY=1``: checks and no mismatch); the
  ensemble and deep-dispatch rounds; the wide-halo round (one exchange
  for four steps); the SLO round (deadline misses counted exactly, one
  postmortem per forced escalation); the overhead budget; the live round
  (two writer processes tailed, windowed counts exact, one alert fire);
  the cost round; the elastic round (rescale down and up, the watchdog
  ladder); the fleet round (two worker processes behind a gateway, one
  SIGKILLed, every scenario retired once); the device timeline (a
  profiled split-phase round merged with the host timeline);
* unless ``--skip-overhead``: telemetry on may not slow the step loop by
  more than ``--threshold`` (default 1.05) against telemetry off, alone
  and with a live tailer running.

The entry point runs on the card unless ``--device cpu`` is given; the
workload's 4 slots are slots of that one device.  Where the port differs
from the JAX gate by design:

* compiles — the port's only compile is a CUDA library built at first use
  (``cuda_build``).  On the card the gate points the kernel build
  directory at a fresh one of its own, so its process compiles every
  library it launches, as a fresh JAX process compiles its kernels; the
  ``compile`` phase and ``epoch.recompiles`` are then required.  On the
  CPU the port compiles nothing at run time and ``CPU_ABSENT`` names the
  two series the gate cannot require there;
* the device timeline — on the card a capture without device events, or
  ``DCCRG_XPLANE=0``, fails the gate; it is the documented no-op on the
  CPU only.  The compiled and the attributed kernel sets meet through
  ``exec_cache.library_labels`` (a library's stem names its kernels'
  labels);
* the overhead measure — the port's step loop is host-bound, and the
  card's host drifts by more than the budget between two loops, so the
  ratio is the median over ``REPS`` rounds of off, on, on, off loops
  (``chip_smoke.py`` phase 29's measure), not the JAX gate's ratio of two
  medians over 11 loops a mode; the fleet probe's scenarios run
  ``FLEET_STEPS`` steps.

``--out`` defaults to ``_telemetry/telemetry.json`` at the checkout's
root; the root ``telemetry.json`` and ``tools/telemetry*`` are the JAX
gate's files and stay untouched.  Side files land beside ``--out``
unless ``--artifact-dir`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

from . import DEFAULT_TELEMETRY

#: the phase set the gate requires (the JAX gate's tuple)
REQUIRED_PHASES = (
    "halo.exchange",
    "epoch.build",
    "epoch.delta_build",
    "loadbalance.migrate",
    "amr.refine",
    "checkpoint.write",
    "lineage.commit",
    "lineage.scan",
    "compile",
    "elastic.rescale",
    "ensemble.admit",
    "ensemble.step",
    "flightrec.dump",
    "cost.estimate",
)

#: counters that must be nonzero after the workload (the JAX gate's tuple)
REQUIRED_NONZERO_COUNTERS = (
    "halo.bytes_moved",
    "halo.cells_moved",
    "amr.cells_refined",
    "checkpoint.bytes_written",
    "epoch.delta_builds",
    "resilience.injected",
    "checkpoint.crc_failures",
    "lineage.generations_skipped",
    "p2p.retries",
    "epoch.recompiles",
    "epoch.cache_hits",
    "halo.backend_schedules",
    "halo.verify_checks",
    "elastic.rescales",
    "elastic.degraded",
    "supervisor.warnings",
    "supervisor.escalations",
    "ensemble.admitted",
    "ensemble.retired",
    "ensemble.steps_served",
    "ensemble.verify_checks",
    "ensemble.deadline_miss",
    "flightrec.dumps",
    "ensemble.admission_estimates",
    "ensemble.device_s_total",
    "gateway.accepted",
    "gateway.rejected",
    "gateway.redispatched",
    "gateway.journal_replays",
)

#: histograms that must carry samples (the JAX gate's tuple)
REQUIRED_HISTOGRAMS = (
    "ensemble.queue_latency",
    "ensemble.queue_wait_s",
    "ensemble.service_s",
    "ensemble.e2e_s",
    "phase.duration_s",
    "cost.step_s",
)

#: required series the port cannot record on the CPU, and why
CPU_ABSENT = {
    "compile": "the port's only compile is a CUDA library build "
               "(cuda_build); the CPU builds none",
    "epoch.recompiles": "counts those builds (same reason)",
}

#: keys every streaming snapshot line must carry
STREAM_REQUIRED_KEYS = ("seq", "ts", "phases", "counters", "gauges",
                        "histograms")

#: the workload's slots (the JAX gate's 4-device virtual mesh)
N_SLOTS = 4

#: the overhead probes' rounds (the JAX gate's 11 single loops a mode): on
#: the card the port's 20-step loop is ~25 ms of host-bound launches whose
#: speed drifts by up to 15% from loop to loop, so 11 rounds leave the
#: median within ±6% of the truth, the budget's own size; 41 bring it to
#: about ±2.5% (PERF.md)
REPS = 41

#: steps of each fleet-probe scenario: the JAX gate's 24 outlast its
#: worker's kill because the worker compiles first; the port compiles
#: nothing at run time and steps 24 in tens of milliseconds, before the
#: gateway reads ``started``, so its scenarios run long enough (about a
#: second on either device) to be killed in flight
FLEET_STEPS = 1200


def validate_stream(path: str, counts: dict | None = None) -> list:
    """Schema-validate a telemetry JSONL stream (``obs.stream_to``
    output); returns failure strings (empty = valid).  A torn final line
    is tolerated when the file does not end in a newline (the
    killed-mid-write case the stream exists to survive), but every
    complete line must parse and the sequence must be coherent.  Pass a
    ``counts`` dict to get the tallies back: ``lines``, ``seq_gaps``
    (missing sequence numbers), ``torn_tail`` and ``bad_lines``."""
    failures: list = []
    if counts is None:
        counts = {}
    counts.update({"lines": 0, "seq_gaps": 0, "torn_tail": 0,
                   "bad_lines": 0})
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [f"stream unreadable: {e}"]
    lines = text.split("\n")
    trailing_partial = lines and lines[-1] != ""
    body = [ln for ln in (lines[:-1] if trailing_partial else lines) if ln]
    if trailing_partial:
        try:
            json.loads(lines[-1])
            body.append(lines[-1])  # complete after all, just no newline
        except json.JSONDecodeError:
            counts["torn_tail"] = 1
    if not body:
        return [f"stream {path} holds no complete snapshot line"]
    prev_seq, prev_ts = None, None
    prev_counters: dict = {}
    for i, ln in enumerate(body):
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            counts["bad_lines"] += 1
            failures.append(f"line {i}: not JSON ({e})")
            continue
        if not isinstance(rec, dict):
            counts["bad_lines"] += 1
            failures.append(f"line {i}: not an object")
            continue
        counts["lines"] += 1
        missing = [k for k in STREAM_REQUIRED_KEYS if k not in rec]
        if missing:
            failures.append(f"line {i}: missing keys {missing}")
            continue
        if prev_seq is not None and rec["seq"] <= prev_seq:
            failures.append(f"line {i}: seq {rec['seq']} not above {prev_seq}")
        elif prev_seq is not None and rec["seq"] > prev_seq + 1:
            counts["seq_gaps"] += rec["seq"] - prev_seq - 1
        if prev_ts is not None and rec["ts"] < prev_ts:
            failures.append(f"line {i}: ts {rec['ts']} went backwards from {prev_ts}")
        # counters are cumulative: a decrease is a reset or a writer bug
        for name, series in rec["counters"].items():
            for label, v in series.items():
                pv = prev_counters.get((name, label))
                if pv is not None and v < pv:
                    failures.append(f"line {i}: counter {name}[{label}] decreased "
                                    f"({pv} -> {v})")
                prev_counters[(name, label)] = v
        prev_seq, prev_ts = rec["seq"], rec["ts"]
    return failures


def validate_chrome_trace(path: str) -> list:
    """Schema-validate a Chrome trace-event export
    (``obs.export_chrome_trace`` output): every ``B`` has a matching ``E``
    of the same name in stack order per (pid, tid), and in-thread
    timestamps never go backwards.  Returns failure strings."""
    failures: list = []
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"trace unreadable: {e}"]
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        return ["trace has no traceEvents list"]
    stacks: dict = {}
    last_ts: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            failures.append(f"event {i}: not a trace event")
            continue
        ph = ev["ph"]
        if ph not in ("B", "E"):
            continue  # X/i/M events are legal, just not produced here
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            failures.append(f"event {i}: bad ts {ts!r}")
            continue
        if ts < last_ts.get(key, float("-inf")):
            failures.append(f"event {i}: ts {ts} went backwards on tid {key}")
        last_ts[key] = ts
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append((ev.get("name"), ts))
        else:
            if not stack:
                failures.append(f"event {i}: E {ev.get('name')!r} with empty stack "
                                f"on tid {key}")
                continue
            bname, bts = stack.pop()
            if bname != ev.get("name"):
                failures.append(f"event {i}: E {ev.get('name')!r} closes B {bname!r}")
            if ts < bts:
                failures.append(f"event {i}: span {bname!r} ends before it begins")
    for key, stack in stacks.items():
        if stack:
            failures.append(f"tid {key}: {len(stack)} unmatched B events "
                            f"({[n for n, _ in stack]})")
    return failures


def artifact_path(out_path: str, suffix: str,
                  artifact_dir: str | None = None) -> str:
    """Where a side file (``<out basename><suffix>``) lands: beside
    ``out_path``, or in ``artifact_dir``."""
    out = pathlib.Path(out_path)
    parent = out.resolve().parent if artifact_dir is None else pathlib.Path(artifact_dir)
    return str(parent / (out.name + suffix))


# ------------------------------------------------------------- workload

def _sync(x) -> None:
    """Wait for the device work behind a tensor (or the tensors of a
    state dict)."""
    import torch

    ts = x.values() if isinstance(x, dict) else [x]
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _cube(n: int, device, hood: int = 0, max_ref: int = 0, lb=None):
    """An n^3 periodic Cartesian grid of the unit cube on ``N_SLOTS``
    slots of ``device`` (not yet refined)."""
    from .. import CartesianGeometry, Grid

    g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(hood)
         .set_periodic(True, True, True).set_maximum_refinement_level(max_ref))
    if lb is not None:
        g = g.set_load_balancing_method(lb)
    return (g.set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / n,) * 3)
            .initialize(n_devices=N_SLOTS, device=device))


def build_workload(device=None):
    """Small refined advection grid: 8^3 level-0 with a refined ball,
    balanced (RCB), then one small commit whose derived state is
    delta-patched, and ``Advection(allow_dense=False)`` on its 4 slots.
    Returns ``(g, adv, state, dt)``."""
    import numpy as np

    from ..models import Advection

    g = _cube(8, device, max_ref=1, lb="RCB")
    ids = g.get_cells()
    r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
    for cid in ids[r < 0.3]:
        g.refine_completely(int(cid))
    g.stop_refining()
    g.balance_load()
    # a closure of a few percent of the grid: the delta rebuild path
    g.refine_completely(int(g.get_cells()[0]))
    g.stop_refining()
    adv = Advection(g, dtype=np.float32, allow_dense=False)
    state = adv.initialize_state()
    dt = np.float32(0.4 * adv.max_time_step(state))
    return g, adv, state, dt


def drive(g, adv, state, dt, steps: int):
    """The timed step loop: a host-level ghost refresh (the instrumented
    halo seam), then one advection step."""
    for _ in range(steps):
        state = {**state,
                 **g.update_copies_of_remote_neighbors({"density": state["density"]})}
        state = adv.step(state, dt)
    _sync(state["density"])
    return state


def drive_split(g, adv, state, dt, steps: int):
    """The split-phase step loop (start the ghost copies, compute the
    interior with no dependence on them, wait and merge): the drive the
    device-timeline probe profiles, whose ``halo.start`` ->
    ``halo.exchange`` windows are the denominator of
    ``overlap.fraction{phase=halo}``."""
    from .. import obs

    for i in range(steps):
        with obs.timeline.context(step=i):
            fields = {"density": state["density"]}
            handle = g.start_remote_neighbor_copy_updates(fields)
            interior = adv.step(state, dt)     # overlaps the exchange
            fields = g.wait_remote_neighbor_copy_updates(fields, handle)
            state = adv.step({**interior, **fields}, dt)
    _sync(state["density"])
    return state


def drive_fused(step_once, state, steps: int):
    """Drive a model's split-phase step (``overlap=True``): each step's
    dispatch is stamped as a ``halo.start`` span and the completing sync
    as the ``halo.exchange`` that finishes it (``obs.events.HALO_FINISH``),
    the window shape ``obs/merge.py`` pairs, so the merged trace measures
    how much device compute the window hid (an upper bound of the true
    in-flight interval)."""
    from .. import obs
    from ..obs.events import HALO_FINISH

    for i in range(steps):
        with obs.timeline.context(step=i):
            t0 = time.perf_counter()
            state = step_once(state)
            obs.metrics.phase_add("halo.start", time.perf_counter() - t0)
            t0 = time.perf_counter()
            _sync(state)
            obs.metrics.phase_add("halo.exchange", time.perf_counter() - t0,
                                  HALO_FINISH)
    return state


def build_fused_model(g, model: str):
    """A split-phase stepper for one model on grid ``g``:
    ``(step_once, state)``.  Shared by the device-timeline probe and
    ``trace_report --run --model``."""
    import numpy as np

    from ..models import Advection, GameOfLife, Vlasov

    if model == "advection":
        adv = Advection(g, dtype=np.float32, allow_dense=False, overlap=True)
        state = adv.initialize_state()
        dt = np.float32(0.4 * adv.max_time_step(state))
        return (lambda s: adv.step(s, dt)), state
    if model == "vlasov":
        vl = Vlasov(g, nv=2, dtype=np.float32, overlap=True)
        state = vl.initialize_state()
        dt = np.float32(0.5 * vl.max_time_step())
        return (lambda s: vl.step(s, dt)), state
    if model == "gol":
        gol = GameOfLife(g, overlap=True)
        state = gol.new_state(alive_cells=g.get_cells()[::3])
        return gol.step, state
    raise ValueError(f"unknown model {model!r}")


def _total(name: str) -> int:
    from .. import obs

    return int(sum(obs.metrics.report()["counters"].get(name, {}).values()))


def _same_bytes(a: dict, b: dict) -> bool:
    """Every field of two states the same bytes."""
    from ..utils.collectives import fetch

    return sorted(a) == sorted(b) and all(
        fetch(a[k]).tobytes() == fetch(b[k]).tobytes() for k in a)


def _dumps(td: str) -> list:
    return sorted(p for p in os.listdir(td)
                  if p.startswith("flightrec_") and p.endswith(".json"))


def _restore_env(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


# --------------------------------------------------------------- probes

def _resilience_probe(g, state) -> list:
    """Forced injection round: a bit flip armed over one of two lineage
    commits must be caught by the scan (it resumes the clean generation),
    and one injected ``p2p.recv`` fault goes through the retry plane
    (``utils.collectives.retrying``) around a real socket receive."""
    import socket

    import numpy as np

    from ..io.checkpoint import CheckpointError
    from ..resilience import CheckpointLineage, inject, plane
    from ..utils.collectives import retrying

    failures: list = []
    spec = {"density": ((), np.float32)}
    with tempfile.TemporaryDirectory() as td:
        lineage = CheckpointLineage(os.path.join(td, "lineage"), keep=3)
        clean_gen = lineage.commit(g, state, spec, user_header=b"clean")
        plane.arm("checkpoint.bit_flip", prob=1.0, seed=0, count=1)
        try:
            corrupt_gen = lineage.commit(g, state, spec, user_header=b"corrupt")
        finally:
            plane.disarm("checkpoint.bit_flip")
        try:
            _g2, _s2, hdr, gen = lineage.latest_valid(spec, n_devices=1,
                                                      device=g.device)
            if gen != clean_gen or hdr != b"clean":
                failures.append(
                    f"lineage scan resumed generation {gen} ({hdr!r}) instead of "
                    f"skipping corrupt generation {corrupt_gen} back to {clean_gen}")
        except CheckpointError as e:
            failures.append(f"lineage scan found no valid generation: {e}")

    # the injected fault raises on the first attempt, the backoff fires,
    # the retry drains the socket
    a, b = socket.socketpair()
    try:
        b.sendall(b"probe-ok")

        def recv8():
            inject.maybe_raise("p2p.recv")
            buf = b""
            while len(buf) < 8:
                buf += a.recv(8 - len(buf))
            return buf

        plane.arm("p2p.recv", prob=1.0, seed=0, count=1)
        try:
            got = retrying(recv8, "recv", peer=0)
        finally:
            plane.disarm("p2p.recv")
        if got != b"probe-ok":
            failures.append(f"retried recv returned {got!r}")
    finally:
        a.close()
        b.close()
    return failures


def _churn_probe(g, dt) -> list:
    """Forced churn cycle pair: each cycle commits a one-cell refinement,
    rebuilds the model and steps; the second, at an unchanged shape
    signature, must compile nothing (``epoch.recompiles`` flat)."""
    import numpy as np

    from ..models import Advection

    failures: list = []

    def cycle(i: int):
        cells = g.get_cells()
        lvl = g.mapping.get_refinement_level(cells)
        cand = cells[lvl < g.mapping.max_refinement_level]
        g.refine_completely(int(cand[(i * 13) % len(cand)]))
        g.stop_refining()
        adv = Advection(g, dtype=np.float32, allow_dense=False)
        st = adv.step(adv.initialize_state(), dt)
        _sync(st["density"])

    cycle(0)
    sig = g.shape_signature()
    before = _total("epoch.recompiles")
    cycle(1)
    if g.shape_signature() != sig:
        failures.append(
            "churn probe: one-cell commit changed the shape signature "
            f"({sig} -> {g.shape_signature()}): bucket hysteresis is not holding shapes")
    elif _total("epoch.recompiles") != before:
        failures.append(
            f"churn probe: second same-signature cycle recompiled "
            f"{_total('epoch.recompiles') - before} kernel(s); it must be zero")
    return failures


def _halo_backend_probe(device) -> list:
    """Forced ``pallas`` backend round: a small grid built under
    ``DCCRG_HALO_BACKEND=pallas`` and ``DCCRG_HALO_VERIFY=1`` runs a
    blocking and a split exchange through the ring copy (kernel B9 on the
    card, its twin on the CPU); the verify oracle must have checked both
    with zero mismatches."""
    import numpy as np

    from .. import Grid

    failures: list = []
    saved = {k: os.environ.get(k) for k in ("DCCRG_HALO_BACKEND", "DCCRG_HALO_VERIFY")}
    os.environ["DCCRG_HALO_BACKEND"] = "pallas"
    os.environ["DCCRG_HALO_VERIFY"] = "1"
    try:
        g = (Grid().set_initial_length((8, 8, 1)).set_neighborhood_length(1)
             .set_load_balancing_method("RCB")
             .initialize(n_devices=N_SLOTS, device=device))
        if g.halo().backend != "pallas":
            return ["halo backend probe: DCCRG_HALO_BACKEND=pallas did not select "
                    f"the pallas transport (got {g.halo().backend!r})"]
        state = g.new_state({"v": ((), np.float64)})
        cells = g.get_cells()
        state = g.set_cell_data(state, "v", cells, np.sin(cells.astype(np.float64)))
        state = g.update_copies_of_remote_neighbors(state)
        handle = g.start_remote_neighbor_copy_updates(state)
        g.wait_remote_neighbor_copy_updates(state, handle)
        checks = _total("halo.verify_checks")
        if checks < 2:
            failures.append(f"halo backend probe: verify oracle ran {checks} checks; "
                            "the blocking + split round must cross-check both")
        mismatches = _total("halo.verify_mismatches")
        if mismatches:
            failures.append(f"halo backend probe: {mismatches} pallas/collective "
                            "mismatches: the ring copy is no longer bit-identical "
                            "to the oracle")
    except Exception as e:  # noqa: BLE001 — a probe reports, the gate fails
        failures.append(f"halo backend probe failed: {e!r}")
    finally:
        _restore_env(saved)
    return failures


def _elastic_probe(g, state) -> list:
    """Forced rescale round (down to half the slots and back up through a
    checkpoint lineage, the payload bit-identical both ways) and the
    watchdog ladder over a synthetic stalled heartbeat (warn ->
    rescale_down -> restart, in order)."""
    import numpy as np

    from .. import obs
    from ..resilience import EscalationLadder, HeartbeatMonitor, Supervisor, rescale

    failures: list = []
    spec = {"density": ((), np.float32)}
    ids = g.get_cells()
    want = np.asarray(g.get_cell_data(state, "density", ids))
    with tempfile.TemporaryDirectory() as td:
        try:
            down = max(1, g.n_devices // 2)
            r = rescale(g, state, spec, down, directory=os.path.join(td, "lineage"),
                        user_header=b"elastic-probe")
            r2 = rescale(r.grid, r.state, spec, g.n_devices,
                         directory=os.path.join(td, "lineage"),
                         user_header=b"elastic-probe")
            for tag, res, nd in (("down", r, down), ("up", r2, g.n_devices)):
                if res.n_devices_after != nd:
                    failures.append(f"elastic probe: rescale {tag} landed on "
                                    f"{res.n_devices_after} slots, wanted {nd}")
                got = np.asarray(res.grid.get_cell_data(res.state, "density", ids))
                if not np.array_equal(got, want):
                    failures.append(f"elastic probe: rescale {tag} altered the payload")
        except Exception as e:  # noqa: BLE001
            failures.append(f"elastic rescale probe failed: {e!r}")

    # an injected clock: the probe never sleeps
    with tempfile.TemporaryDirectory() as td:
        try:
            hb = os.path.join(td, "hb.jsonl")
            s = obs.TelemetryStream(hb, period=3600.0, truncate=True)
            s.write_snapshot(step=0)
            mon = HeartbeatMonitor(hb, stall_after_s=1.0, now=0.0)
            sup = Supervisor(mon, ladder=EscalationLadder())
            first = sup.poll(now=0.5)
            if first["status"] != "ok":
                failures.append(f"elastic probe: fresh heartbeat read as {first['status']}")
            acts = [sup.poll(now=10.0 + i)["action"] for i in range(3)]
            if acts != ["warn", "rescale_down", "restart"]:
                failures.append(f"elastic probe: escalation ladder ran {acts}, wanted "
                                "['warn', 'rescale_down', 'restart']")
        except Exception as e:  # noqa: BLE001
            failures.append(f"elastic watchdog probe failed: {e!r}")
    return failures


def _gol_members(g, seed: int, allow_dense: bool = False, hood_id=None):
    """``(gol, mk)``: a gather-path Game of Life on ``g`` and a maker of
    seeded 30%-alive member states."""
    import numpy as np

    from ..models import GameOfLife

    gol = GameOfLife(g, hood_id=hood_id, allow_dense=allow_dense)
    cells = g.get_cells()
    rng = np.random.default_rng(seed)
    return gol, lambda: gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])


def _ensemble_probe(device) -> list:
    """Ensemble serving round with the solo-replay oracle armed: a second
    admission wave at the held cohort width compiles nothing, the oracle
    checks with no mismatch, a member retires bitwise equal to solo
    stepping, the peak-occupancy gauge lands in (0, 1]; then the same at
    four steps a dispatch, with the depth and per-member memory gauges."""
    from .. import obs
    from ..serve import Ensemble

    failures: list = []
    try:
        g = _cube(4, device)
        g.stop_refining()
        gol, mk = _gol_members(g, 0)

        ens = Ensemble(verify=True)
        first = [mk() for _ in range(4)]
        tickets = [ens.submit(gol, s, steps=3, tenant=f"tenant{i % 2}")
                   for i, s in enumerate(first)]
        ens.run()                                # builds the cohort body
        before = _total("epoch.recompiles")
        for s in (mk() for _ in range(4)):       # churn at held width
            ens.submit(gol, s, steps=2)
        ens.run()
        if _total("epoch.recompiles") != before:
            failures.append(f"ensemble probe: admission/retirement at a held signature "
                            f"recompiled {_total('epoch.recompiles') - before} kernel(s)")
        ref = first[0]
        for _ in range(3):
            ref = gol.step(ref)
        if not _same_bytes(ref, tickets[0].result):
            failures.append("ensemble probe: cohort-stepped member diverged from solo "
                            "stepping (bit-identity anchor broken)")
        if _total("ensemble.verify_checks") < 2:
            failures.append(f"ensemble probe: verify oracle ran "
                            f"{_total('ensemble.verify_checks')} checks; the armed round "
                            "must replay sampled members")
        if _total("ensemble.verify_mismatches"):
            failures.append(f"ensemble probe: {_total('ensemble.verify_mismatches')} "
                            "cohort/solo mismatches")
        occ = obs.metrics.report()["gauges"].get("ensemble.cohort_peak_occupancy", {})
        if not occ:
            failures.append("ensemble probe: ensemble.cohort_peak_occupancy gauge missing "
                            "after the serving round")
        elif not all(0.0 < v <= 1.0 for v in occ.values()):
            failures.append(f"ensemble probe: peak occupancy out of (0, 1]: {occ}")

        # deep dispatch: k=4 bitwise 4 solo steps, churn at the held
        # (signature, width, k) compiles nothing, the gauges land
        ens4 = Ensemble(verify=True, steps_per_dispatch=4)
        deep = [mk() for _ in range(4)]
        deep_tickets = [ens4.submit(gol, s, steps=8) for s in deep]
        ens4.run()
        before = _total("epoch.recompiles")
        for s in (mk() for _ in range(4)):
            ens4.submit(gol, s, steps=8)
        ens4.run()
        if _total("epoch.recompiles") != before:
            failures.append(f"ensemble probe: k=4 churn at a held (signature, width, k) "
                            f"recompiled {_total('epoch.recompiles') - before} kernel(s)")
        ref4 = deep[0]
        for _ in range(8):
            ref4 = gol.step(ref4)
        if not _same_bytes(ref4, deep_tickets[0].result):
            failures.append("ensemble probe: k=4 deep dispatch diverged from 8 solo "
                            "steps (k-step bit-identity anchor broken)")
        if _total("ensemble.verify_mismatches"):
            failures.append(f"ensemble probe: {_total('ensemble.verify_mismatches')} "
                            "cohort/solo mismatches after the deep-dispatch round")
        gauges = obs.metrics.report()["gauges"]
        kgauge = gauges.get("ensemble.steps_per_dispatch", {})
        if not any(v > 0 for v in kgauge.values()):
            failures.append("ensemble probe: ensemble.steps_per_dispatch gauge missing "
                            f"or zero after a k=4 round: {kgauge}")
        hbm_g = gauges.get("ensemble.hbm_bytes_per_member", {})
        if not any(v > 0 for v in hbm_g.values()):
            failures.append("ensemble probe: ensemble.hbm_bytes_per_member gauge "
                            f"missing or zero after the serving rounds: {hbm_g}")
    except Exception as e:  # noqa: BLE001
        failures.append(f"ensemble probe failed: {e!r}")
    return failures


def _wide_halo_probe(device) -> list:
    """Exchange-amortized deep dispatch: k=4 on a depth-4 ghost zone pays
    one exchange a dispatch (``halo.exchanges_per_step{model=gol}`` reads
    0.25) with the oracle armed and clean; a second wave at the held
    (signature, width, k, g) compiles nothing; owned rows match 8 solo
    steps."""
    from .. import obs
    from ..parallel import halo
    from ..serve import Ensemble
    from ..utils.collectives import fetch

    failures: list = []
    try:
        g = _cube(6, device, hood=4)
        g.stop_refining()
        moore = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)]
        g.add_neighborhood(7, moore)
        gol, mk = _gol_members(g, 0, hood_id=7)
        spec = gol.batch_step_spec()
        if spec.wide is None or spec.wide.budget < 4:
            return ["wide-halo probe: no engageable wide plan on a depth-4 hood "
                    f"(wide={spec.wide!r}); exchange amortization cannot run"]
        halo._amortization.clear()
        ens = Ensemble(verify=True, steps_per_dispatch=4)
        first = [mk() for _ in range(4)]
        tickets = [ens.submit(gol, s, steps=8, tenant="wide") for s in first]
        ens.run()
        before = _total("epoch.recompiles")
        for s in (mk() for _ in range(4)):
            ens.submit(gol, s, steps=4, tenant="wide")
        ens.run()
        if _total("epoch.recompiles") != before:
            failures.append(f"wide-halo probe: churn at a held (signature, width, k, g) "
                            f"recompiled {_total('epoch.recompiles') - before} kernel(s)")
        got = obs.metrics.report()["gauges"].get(
            "halo.exchanges_per_step", {}).get("model=gol")
        if got != 0.25:
            failures.append(f"wide-halo probe: halo.exchanges_per_step = {got!r} after "
                            "k=4 wide rounds; one exchange must fund 4 interior steps "
                            "(wanted 0.25)")
        if _total("ensemble.verify_checks") < 2:
            failures.append(f"wide-halo probe: verify oracle ran "
                            f"{_total('ensemble.verify_checks')} checks")
        if _total("ensemble.verify_mismatches"):
            failures.append(f"wide-halo probe: {_total('ensemble.verify_mismatches')} "
                            "cohort/solo mismatches")
        ref = first[0]
        for _ in range(8):
            ref = gol.step(ref)
        lm = fetch(spec.wide.local_mask)
        for name in sorted(ref):
            a, b = fetch(ref[name]), fetch(tickets[0].result[name])
            if a.shape[:2] == lm.shape:
                a, b = a[lm], b[lm]
            if a.tobytes() != b.tobytes():
                failures.append(f"wide-halo probe: field {name!r} diverged from 8 solo "
                                "steps on owned rows")
    except Exception as e:  # noqa: BLE001
        failures.append(f"wide-halo probe failed: {e!r}")
    return failures


def _slo_probe(device) -> list:
    """Request-level SLO round: a deadline-mixed ensemble round (half the
    deadlines already passed) leaves the latency histograms with ordered
    quantiles, exactly the scripted deadline misses and the request
    lifecycle spans; a forced escalation with the flight recorder armed
    leaves exactly one valid postmortem naming request activity."""
    import shutil

    from .. import obs
    from ..obs import flight_recorder, slo, validate_flightrec
    from ..resilience import EscalationLadder
    from ..serve import Ensemble

    failures: list = []
    prev_dir = flight_recorder.armed_dir
    td = tempfile.mkdtemp(prefix="dccrg_slo_probe_")
    try:
        flight_recorder.arm(td, autodump=False)
        g = _cube(4, device)
        g.stop_refining()
        gol, mk = _gol_members(g, 1)
        before_miss = _total("ensemble.deadline_miss")
        ens = Ensemble(policy="deadline")
        now = time.perf_counter()
        expect_missed = 0
        for i in range(6):
            past = i % 2 == 0
            ens.submit(gol, mk(), steps=2 + i % 3, tenant=f"tenant{i % 2}",
                       deadline=now - 1.0 if past else now + 3600.0)
            expect_missed += past
        ens.run()

        rep = obs.metrics.report()
        for name in ("ensemble.queue_wait_s", "ensemble.e2e_s", "ensemble.service_s"):
            series = rep["histograms"].get(name)
            if not series:
                failures.append(f"slo probe: histogram {name!r} missing after the "
                                "deadline-mixed round")
                continue
            for label, h in series.items():
                p50, p95, p99 = (slo.quantile(h, q) for q in (0.5, 0.95, 0.99))
                if p50 is None or not (p50 <= p95 <= p99):
                    failures.append(f"slo probe: {name}{{{label}}} quantiles out of "
                                    f"order: p50={p50} p95={p95} p99={p99}")
        missed = _total("ensemble.deadline_miss") - before_miss
        if missed != expect_missed:
            failures.append(f"slo probe: {missed} deadline misses counted, expected "
                            f"exactly {expect_missed} (past-deadline submissions)")
        span_names = {s["name"] for s in obs.timeline.spans()}
        for wanted in ("request.queued", "request.step", "request.e2e"):
            if wanted not in span_names:
                failures.append(f"slo probe: lifecycle span {wanted!r} missing from "
                                "the timeline after the serving round")

        ladder = EscalationLadder()
        for _ in range(3):
            ladder.escalate("slo-probe-stall")
        dumps = _dumps(td)
        if len(dumps) != 1:
            failures.append(f"slo probe: forced escalation left {len(dumps)} "
                            f"flight-recorder dumps ({dumps}), wanted exactly one")
        for p in dumps:
            full = os.path.join(td, p)
            failures += [f"flightrec {p}: {f}" for f in validate_flightrec(full)]
            with open(full) as f:
                rec = json.load(f)
            named = any(str(ev.get("kind", "")).startswith("request.")
                        for ev in rec.get("events", [])) or any(
                str(sp.get("name", "")).startswith("request.")
                for sp in rec.get("spans", []))
            if not named:
                failures.append(f"slo probe: postmortem {p} names no request activity "
                                "from the serving round")
    except Exception as e:  # noqa: BLE001
        failures.append(f"slo probe failed: {e!r}")
    finally:
        if prev_dir is not None:
            flight_recorder.arm(prev_dir)
        else:
            flight_recorder.disarm()
        shutil.rmtree(td, ignore_errors=True)
    return failures


def _fleet_probe(device) -> list:
    """Fleet gateway round: two worker processes (4 slots each, on
    ``device``) behind an in-process gateway.  One overflow submission is
    rejected at the pinned queue bound; one worker is SIGKILLed once it
    reports ``started``, its in-flight scenarios redispatch and every
    accepted scenario retires exactly once (one redispatched member
    bitwise equal to uninterrupted solo stepping); the loss leaves exactly
    one valid postmortem naming the worker; a journal reopen replays the
    retired set."""
    import shutil

    import numpy as np

    from ..obs import flight_recorder, validate_flightrec
    from ..serve import Ensemble, Gateway, SubmissionJournal, WorkerHandle
    from ..serve.worker import build_scenario

    failures: list = []
    watched = ("gateway.accepted", "gateway.rejected", "gateway.redispatched",
               "gateway.worker_lost", "gateway.retired", "gateway.journal_replays")
    before = {n: _total(n) for n in watched}
    prev_dir = flight_recorder.armed_dir
    td = tempfile.mkdtemp(prefix="dccrg_fleet_probe_")
    saved_env = {k: os.environ.get(k) for k in ("DCCRG_GATEWAY_QUEUE_MAX",
                                                "DCCRG_GATEWAY_STALL_S",
                                                "DCCRG_COMPILE_CACHE_DIR")}
    dev = str(device)
    gw = None
    try:
        fr_dir = os.path.join(td, "flightrec")
        os.makedirs(fr_dir)
        flight_recorder.arm(fr_dir, autodump=False)
        # a worker's cold start outlasts the default stall budget; the
        # kill below is the only loss this probe scripts
        os.environ["DCCRG_GATEWAY_STALL_S"] = "120"
        os.environ["DCCRG_GATEWAY_QUEUE_MAX"] = "4"
        os.environ["DCCRG_COMPILE_CACHE_DIR"] = os.path.join(td, "cache")
        workers = [WorkerHandle(w, os.path.join(td, w), n_devices=N_SLOTS, device=dev)
                   for w in ("w0", "w1")]
        for w in workers:
            w.start()
        gw = Gateway(os.path.join(td, "journal.jsonl"), workers)
        specs = [{"sid": f"fp{i}", "model": "gol", "n": 8, "seed": i,
                  "steps": FLEET_STEPS, "tenant": "fleet"} for i in range(4)]
        for s in specs:
            ok, why = gw.submit(dict(s))
            if not ok:
                failures.append(f"fleet probe: {s['sid']} rejected ({why})")
        ok, why = gw.submit({"sid": "fp-overflow", "model": "gol", "steps": 1,
                             "tenant": "fleet"})
        if ok or why != "queue-full":
            failures.append("fleet probe: overflow submission past the pinned queue "
                            f"bound was not rejected (got {(ok, why)!r})")
        gw.tick(restart_lost=False)
        victim = "w0" if gw.journal.in_flight("w0") else "w1"
        survivor = "w1" if victim == "w0" else "w0"
        victim_sids = set(gw.journal.in_flight(victim))
        if not victim_sids:
            failures.append("fleet probe: no in-flight work assigned to the victim")
        # SIGKILL the victim once it reports 'started' (really stepping)
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            gw.tick(restart_lost=False)
            if any(gw.journal.accepted[s].get("sig") for s in victim_sids):
                break
            time.sleep(0.02)
        else:
            failures.append("fleet probe: victim never reported 'started' in 180s")
        victim_sids = set(gw.journal.in_flight(victim))
        gw.workers[victim].kill()
        if not gw.run_until_drained(timeout_s=300.0, restart_lost=False):
            failures.append("fleet probe: fleet failed to drain within 300s after the "
                            "forced worker kill")
        accepted = set(gw.journal.accepted)
        if set(gw.journal.retired) != accepted:
            failures.append(f"fleet probe: retired {sorted(gw.journal.retired)} != "
                            f"accepted {sorted(accepted)}")
        d_retired = _total("gateway.retired") - before["gateway.retired"]
        if d_retired != len(specs):
            failures.append(f"fleet probe: {d_retired} retirements counted, wanted "
                            f"exactly {len(specs)}")
        if _total("gateway.worker_lost") - before["gateway.worker_lost"] != 1:
            failures.append("fleet probe: the one forced kill did not count as exactly "
                            "one gateway.worker_lost")
        d_re = _total("gateway.redispatched") - before["gateway.redispatched"]
        if d_re != len(victim_sids):
            failures.append(f"fleet probe: {d_re} redispatches counted, wanted "
                            f"{len(victim_sids)} (the victim's in-flight set)")
        if _total("gateway.accepted") - before["gateway.accepted"] != len(specs):
            failures.append("fleet probe: accepted count does not match the submitted "
                            "fleet")
        if victim_sids and not failures:
            sid = sorted(victim_sids)[0]
            res = os.path.join(gw.workers[survivor].workdir, f"result_{sid}.npz")
            spec = next(s for s in specs if s["sid"] == sid)
            bundle = build_scenario(spec, n_devices=N_SLOTS, device=dev)
            ens = Ensemble()
            t = ens.submit(bundle["model"], bundle["state"], steps=int(spec["steps"]),
                           dt=bundle["dt"])
            ens.run()
            want = np.sort(np.asarray(bundle["model"].alive_cells(t.result)))
            try:
                with np.load(res) as z:
                    got = np.asarray(z["alive"])
                if not np.array_equal(want, got):
                    failures.append(f"fleet probe: redispatched member {sid} is not "
                                    "bit-identical to uninterrupted solo stepping")
            except OSError as e:
                failures.append(f"fleet probe: result park for {sid} unreadable: {e}")
        dumps = _dumps(fr_dir)
        if len(dumps) != 1:
            failures.append(f"fleet probe: worker loss left {len(dumps)} flight-recorder "
                            f"dumps ({dumps}), wanted exactly one")
        for p in dumps:
            full = os.path.join(fr_dir, p)
            failures += [f"fleet flightrec {p}: {f}" for f in validate_flightrec(full)]
            with open(full) as f:
                rec = json.load(f)
            if not any(ev.get("kind") == "worker.lost" and ev.get("worker") == victim
                       for ev in rec.get("events", [])):
                failures.append(f"fleet probe: postmortem {p} does not name the lost "
                                f"worker {victim}")
        j2 = SubmissionJournal(gw.journal.path)
        if set(j2.retired) != accepted:
            failures.append("fleet probe: journal reopen lost the retired set")
        j2.close()
        if _total("gateway.journal_replays") - before["gateway.journal_replays"] < 1:
            failures.append("fleet probe: journal reopen did not count a replay")
    except Exception as e:  # noqa: BLE001
        failures.append(f"fleet probe failed: {e!r}")
    finally:
        if gw is not None:
            gw.close()
        _restore_env(saved_env)
        if prev_dir is not None:
            flight_recorder.arm(prev_dir)
        else:
            flight_recorder.disarm()
        shutil.rmtree(td, ignore_errors=True)
    return failures


def _cost_probe(device) -> list:
    """Cost and capacity round with the cost model armed: every stepped
    cohort-body key has samples in the process model and in the exported
    ``cost.step_s`` series; ``predict`` answers at the exact level for a
    stepped key and at ``global`` for a novel kind; chargeback conserves
    the recorded wall x mesh total; a two-tenant burst into a width-capped
    cohort queues, and the queue-wait predicted at submit time is within
    one calibration bucket of the measured p95.  Advection on its own
    grid, so its ``model=advection*`` series leave the GoL ones alone."""
    import numpy as np

    from .. import obs
    from ..models import Advection
    from ..obs import cost, slo
    from ..serve import Ensemble

    failures: list = []
    try:
        if not cost.enabled():
            return ["cost probe: DCCRG_COST_MODEL is off; the probe (and the "
                    "overhead budget) must run with the model armed"]
        g = _cube(4, device)
        g.stop_refining()
        adv = Advection(g, dtype=np.float32, allow_dense=False)
        dt = np.float32(0.4 * adv.max_time_step(adv.initialize_state()))
        mk = adv.initialize_state

        ens = Ensemble(steps_per_dispatch=4)
        for i in range(4):
            ens.submit(adv, mk(), steps=8, dt=dt, tenant=f"ct{i % 2}")
        ens.run()
        rep = obs.metrics.report()
        series = rep["histograms"].get(cost.COST_HISTOGRAM) or {}
        if not series:
            failures.append("cost probe: no cost.step_s series after the mixed-tenant "
                            "round")
        local = cost.model.series()
        for label, h in series.items():
            mine = local.get(label)
            if mine is None or mine["count"] < h["count"]:
                failures.append(f"cost probe: model/registry divergence at {label!r}")
        for label in series:
            kv = cost.parse_label(label)
            est = cost.model.predict(kv["model"], sig=kv["sig"], k=kv["k"], g=kv["g"],
                                     w=kv["w"])
            if est is None or est.level != "exact" or est.n < 1:
                failures.append(f"cost probe: predict({label!r}) did not answer at the "
                                f"exact level: {est}")
        novel = cost.model.predict("no-such-model-kind")
        if novel is None or novel.level != "global":
            failures.append("cost probe: fallback chain broken: a novel model kind "
                            f"must answer at the global level, got {novel}")

        cons = cost.conservation(rep)
        if not cons["ok"]:
            failures.append(f"cost probe: chargeback conservation violated: attributed "
                            f"{cons['attributed']:.6f}s vs wall x mesh total "
                            f"{cons['total']:.6f}s (ratio {cons['ratio']})")
        ledger = cost.chargeback(rep)
        if not any(t.startswith("ct") for t in ledger):
            failures.append(f"cost probe: mixed-tenant round missing from the "
                            f"chargeback ledger: {sorted(ledger)}")

        burst = Ensemble(steps_per_dispatch=4, max_width=4)
        for _ in range(4):
            burst.submit(adv, mk(), steps=8, dt=dt, tenant="cwarm")
        burst.run()                  # the first (W=4, k=4) dispatches
        cost.tracker.reset()         # drop first-dispatch timings
        for _ in range(4):
            burst.submit(adv, mk(), steps=8, dt=dt, tenant="cwarm")
        burst.run()                  # a clean wave trains the rate window
        for i in range(16):
            burst.submit(adv, mk(), steps=8, dt=dt, tenant=f"cburst{i % 2}")
        predicted = {
            cost.parse_label(label).get("tenant"): float(v)
            for label, v in (obs.metrics.report()["gauges"]
                             .get("cost.predicted_queue_wait_s") or {}).items()}
        burst.run()
        waits = obs.metrics.report()["histograms"].get("ensemble.queue_wait_s") or {}
        for tenant in ("cburst0", "cburst1"):
            pred = predicted.get(tenant)
            if not pred or pred <= 0:
                failures.append(f"cost probe: no predicted queue-wait gauge for burst "
                                f"tenant {tenant!r} at submit time")
                continue
            h = waits.get(f"tenant={tenant}")
            measured = slo.quantile(h, 0.95) if h else None
            if not measured:
                failures.append(f"cost probe: no measured queue-wait for burst tenant "
                                f"{tenant!r}")
                continue
            ratio = pred / measured
            b = cost.CALIBRATION_BUCKET
            if not (1.0 / b <= ratio <= b):
                failures.append(
                    f"cost probe: predicted queue-wait off by more than one calibration "
                    f"bucket for {tenant!r}: predicted {pred:.4f}s vs measured p95 "
                    f"{measured:.4f}s (ratio {ratio:.2f}, envelope [{1.0 / b:.2f}, "
                    f"{b:.2f}])")
    except Exception as e:  # noqa: BLE001
        failures.append(f"cost probe failed: {e!r}")
    return failures


#: the live probe's stream writer: the port's registry (``obs/registry.py``,
#: standard library only, imported as the top-level module ``registry``
#: from the package's ``obs`` directory, so the writer imports no torch)
#: records a fixed sample schedule at the SLO bucket resolution into
#: hand-written stream lines; writer 1 also skips two sequence numbers and
#: ends on a torn (newline-less) line
_LIVE_WRITER_SRC = r"""
import json, sys, time
obs_dir, out_path, wid = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, obs_dir)
import registry
assert "torch" not in sys.modules, "the registry import pulled in torch"
reg = registry.MetricsRegistry(enabled=True)
reg.set_histogram_resolution("ensemble.e2e_s", 8)
tenant = "t%d" % wid
seq = 0
f = open(out_path, "w")
def snap():
    global seq
    rec = {"seq": seq, "ts": time.time(), **reg.report()}
    f.write(json.dumps(rec, default=float) + "\n")
    f.flush()
    seq += 1
for j in range(30):
    v = 0.001 * (1 + ((7 * j + 3 * wid) % 40))
    reg.observe("ensemble.e2e_s", v, tenant=tenant)
    reg.inc("ensemble.steps_served", 1, tenant=tenant)
    if j % 5 == 0:
        reg.inc("ensemble.deadline_miss", 1, tenant=tenant)
    if j % 3 == 0:
        snap()
    time.sleep(0.005)
if wid == 1:
    seq += 2  # injected seq gap: two line numbers never written
snap()
if wid == 1:
    f.write('{"seq": %d, "ts"' % seq)  # torn final line: cut mid-write
    f.flush()
f.close()
"""


def _live_probe(g, adv, state, dt, steps: int, reps: int = REPS,
                threshold: float = 1.05, skip_overhead: bool = False) -> list:
    """Live-telemetry round: two writer processes stream registry
    snapshots (one with a seq gap and a torn final line) while the
    aggregator tails them.  Windowed counts equal the writers' totals; the
    windowed quantiles are within one bucket of the pooled post-hoc ones;
    the tailer and :func:`validate_stream` count the same gaps and torn
    tails; a forced deadline-miss burst fires its alert rule exactly once
    with one valid postmortem naming it; and the overhead budget
    re-passes with a tailer polling the probe's own stream."""
    import shutil
    import subprocess
    import threading

    from .. import obs
    from ..obs import alerts as alerts_mod
    from ..obs import flight_recorder, live, slo, validate_flightrec

    failures: list = []
    obs_dir = str(pathlib.Path(obs.__file__).resolve().parent)
    prev_dir = flight_recorder.armed_dir
    td = tempfile.mkdtemp(prefix="dccrg_live_probe_")
    try:
        paths = [os.path.join(td, f"writer{i}.stream.jsonl") for i in (0, 1)]
        procs = [subprocess.Popen([sys.executable, "-c", _LIVE_WRITER_SRC, obs_dir,
                                   paths[i], str(i)]) for i in (0, 1)]
        agg = live.FleetAggregator(td, window_s=3600.0)
        while any(p.poll() is None for p in procs):
            agg.poll()
            time.sleep(0.02)
        for i, p in enumerate(procs):
            if p.returncode != 0:
                failures.append(f"live probe: writer {i} exited {p.returncode}")
        agg.poll()  # the final lines (and the torn fragment)
        view = agg.view()

        served = view.counter("ensemble.steps_served")
        missed = view.counter("ensemble.deadline_miss")
        e2e = view.histogram("ensemble.e2e_s")
        if served != 60:
            failures.append(f"live probe: windowed ensemble.steps_served {served} != 60 "
                            "(2 writers x 30): the tailer dropped lines")
        if missed != 12:
            failures.append(f"live probe: windowed ensemble.deadline_miss {missed} != 12 "
                            "(2 writers x 6)")
        if int(e2e.get("count") or 0) != 60:
            failures.append(f"live probe: windowed e2e histogram count "
                            f"{e2e.get('count')} != 60")

        pooled = slo.merge_series([slo.load_report(p) for p in paths], "ensemble.e2e_s")
        pooled_all = slo.merge(*pooled.values()) if pooled else {}
        for q in (0.5, 0.95, 0.99):
            live_q = view.quantile("ensemble.e2e_s", q)
            post_q = slo.quantile(pooled_all, q)
            if live_q is None or post_q is None:
                failures.append(f"live probe: q={q} unavailable (live={live_q}, "
                                f"pooled={post_q})")
                continue
            bucket = 2.0 ** (1.0 / slo.SLO_RESOLUTION)
            if not (post_q / bucket <= live_q <= post_q * bucket + 1e-12):
                failures.append(f"live probe: windowed p{round(q * 100)} {live_q} not "
                                f"within one bucket of pooled {post_q}")

        if view.health["seq_gaps"] != 2:
            failures.append(f"live probe: tailer counted {view.health['seq_gaps']} seq "
                            "gaps, expected exactly 2 (injected)")
        if view.health["torn_tails"] < 1:
            failures.append("live probe: the torn final line was never counted")
        counts: dict = {}
        failures += [f"live probe writer1 stream: {f}"
                     for f in validate_stream(paths[1], counts)]
        if counts.get("seq_gaps") != 2 or counts.get("torn_tail") != 1:
            failures.append(f"live probe: validate_stream counted {counts}, expected "
                            "seq_gaps=2 torn_tail=1")

        flight_recorder.arm(td, autodump=False)
        rule = alerts_mod.AlertRule("burst-miss-rate", "ensemble.deadline_miss",
                                    source="miss_rate", kind="ceiling",
                                    threshold=0.01, clear=0.005, for_s=0.0)
        engine = alerts_mod.AlertEngine([rule], registry=obs.metrics,
                                        flight_recorder=flight_recorder)
        for _ in range(4):  # the burst persists: no flap
            engine.poll(view)
        st = engine.state("burst-miss-rate")
        if st["fires"] != 1 or st["clears"] != 0 or st["status"] != "firing":
            failures.append(f"live probe: alert fired {st['fires']}x cleared "
                            f"{st['clears']}x status={st['status']}; wanted exactly one "
                            "fire, still firing (no flap)")
        dumps = _dumps(td)
        if len(dumps) != 1:
            failures.append(f"live probe: alert firing left {len(dumps)} dumps "
                            f"({dumps}), wanted exactly one per incident")
        for p in dumps:
            full = os.path.join(td, p)
            failures += [f"live probe flightrec {p}: {f}" for f in validate_flightrec(full)]
            with open(full) as fh:
                rec = json.load(fh)
            named = "burst-miss-rate" in str(rec.get("reason", "")) or any(
                ev.get("rule") == "burst-miss-rate" for ev in rec.get("events", [])
                if isinstance(ev, dict))
            if not named:
                failures.append(f"live probe: postmortem {p} does not name the firing "
                                "rule")

        if not skip_overhead:
            stream_path = os.path.join(td, "probe.stream.jsonl")
            s = obs.TelemetryStream(stream_path, period=0.05, truncate=True)
            s.start()
            tail_agg = live.FleetAggregator([stream_path], window_s=60.0)
            stop_evt = threading.Event()

            def _tail_loop():
                while not stop_evt.is_set():
                    tail_agg.poll()
                    stop_evt.wait(0.05)

            t = threading.Thread(target=_tail_loop, daemon=True)
            t.start()
            try:
                over = _overhead_probe(g, adv, state, dt, steps, reps=reps,
                                       threshold=threshold)
                failures += [f"with live tailer: {f}" for f in over]
            finally:
                stop_evt.set()
                t.join(timeout=5.0)
                s.stop(final=False)
    except Exception as e:  # noqa: BLE001
        failures.append(f"live probe failed: {e!r}")
    finally:
        if prev_dir is not None:
            flight_recorder.arm(prev_dir)
        else:
            flight_recorder.disarm()
        shutil.rmtree(td, ignore_errors=True)
    return failures


def compiled_labels(recompiles: dict) -> set:
    """The device-timeline labels of the kernels in the libraries an
    ``epoch.recompiles`` series counts (``{"kernel=<stem>": n}``)."""
    from ..parallel.exec_cache import library_labels

    out = set()
    for key in recompiles:
        if "=" in key:
            out |= library_labels(key.split("=", 1)[1])
    return out


def _device_timeline_probe(g, adv, state, dt, out_path: str,
                           merged_path: str | None = None) -> list:
    """Profiled round: one split-phase drive captured under
    ``obs.profile_trace``, merged with the host timeline; then the
    split-phase advection and Vlasov steps, each under its own
    ``model`` label.  Requires a valid merged trace, ``overlap.fraction
    {phase=halo}`` and the per-model fractions in (0, 1], the busy gauges,
    and kernel attribution that meets the compiled set.  On the card a
    capture without device events, or ``DCCRG_XPLANE=0``, is a failure;
    on the CPU it is the documented no-op."""
    from .. import obs
    from ..obs.kineto import kineto_enabled

    on_card = g.device.type == "cuda"
    if not kineto_enabled():
        if on_card:
            return ["device-timeline probe: DCCRG_XPLANE=0 switches off the device "
                    "timeline the gate must measure on the card"]
        print("device-timeline probe skipped (DCCRG_XPLANE=0)", file=sys.stderr)
        return []
    if merged_path is None:
        merged_path = artifact_path(out_path, ".merged_trace.json")
    with tempfile.TemporaryDirectory() as td:
        try:
            with obs.profile_trace(td):
                drive_split(g, adv, state, dt, 6)
            # the exported trace keeps the longest spans a device; the
            # gauges use them all
            _merged, summary = obs.merge_profile(td, out_path=merged_path,
                                                 out_max_spans=250)
        except Exception as e:  # noqa: BLE001
            return [f"device-timeline probe failed: {e!r}"]
    if not summary["device_evidence"]:
        if on_card:
            return ["device-timeline probe: the capture holds no device execution "
                    "lines on the card"]
        print("device-timeline probe: capture holds no execution lines (no device) "
              "- overlap/busy gauges not required", file=sys.stderr)
        return []
    failures: list = []
    for model in ("advection", "vlasov"):
        try:
            step_once, mstate = build_fused_model(g, model)
            mstate = drive_fused(step_once, mstate, 1)   # first launches
            with tempfile.TemporaryDirectory() as td:
                with obs.profile_trace(td):
                    drive_fused(step_once, mstate, 4)
                obs.merge_profile(td, extra_labels={"model": model})
        except Exception as e:  # noqa: BLE001
            failures.append(f"split-phase {model} probe failed: {e!r}")
    rep = obs.metrics.report()
    gauges = rep["gauges"]
    frac = gauges.get("overlap.fraction", {}).get("phase=halo")
    if frac is None:
        failures.append("overlap.fraction{phase=halo} gauge missing after the profiled "
                        "round")
    elif not 0.0 < frac <= 1.0:
        failures.append(f"overlap.fraction{{phase=halo}} = {frac}: the split-phase probe "
                        "must measure nonzero in-(0,1] overlap")
    for model in ("advection", "vlasov"):
        mfrac = gauges.get("overlap.fraction", {}).get(f"model={model},phase=halo")
        if mfrac is None:
            failures.append(f"overlap.fraction{{model={model},phase=halo}} gauge missing "
                            "after the split-phase round")
        elif not 0.0 < mfrac <= 1.0:
            failures.append(f"overlap.fraction{{model={model},phase=halo}} = {mfrac}: the "
                            "round must measure nonzero in-(0,1] overlap")
    if not gauges.get("device.busy_fraction"):
        failures.append("device.busy_fraction{device=d} gauges missing after the "
                        "profiled round")
    attributed = {k.split("=", 1)[1] for k in rep["counters"].get(
        "device.kernel_time_us", {}) if "=" in k}
    compiled = compiled_labels(rep["counters"].get("epoch.recompiles", {}))
    if not attributed & compiled:
        failures.append(
            "device-time attribution names never meet the compiled kernel set "
            f"(attributed: {sorted(attributed)[:6]}; compiled: {sorted(compiled)[:6]}): "
            "the compiled->ran loop is broken")
    failures += [f"merged trace: {f}" for f in obs.validate_merged_trace(merged_path)]
    return failures


def overhead_ratio(loop, reps: int = REPS) -> float:
    """Telemetry-on over telemetry-off cost: ``loop(enabled)`` runs and
    times one loop with telemetry so and returns its seconds.  ``reps``
    rounds of four loops, off, on, on, off (on, off, off, on in every
    other round): a round's ratio is its two on loops over its two off
    loops, so a drift of the host's or the card's speed within it
    cancels, and the result is the median of the rounds' ratios
    (``chip_smoke.py`` phase 29's measure).  Garbage is collected first;
    telemetry is on again after."""
    import gc
    import statistics

    from .. import obs

    ratios = []
    gc.collect()
    try:
        for i in range(reps):
            got = {True: 0.0, False: 0.0}
            order = (False, True, True, False) if i % 2 == 0 else (True, False, False, True)
            for enabled in order:
                got[enabled] += loop(enabled)
            ratios.append(got[True] / got[False])
    finally:
        obs.enable()
    return statistics.median(ratios)


def overhead_loop(g, adv, state, dt, steps: int):
    """The overhead budget's loop: ``steps`` steps of :func:`drive` with
    telemetry on or off, timed on the host clock."""
    from .. import obs

    def loop(enabled: bool) -> float:
        obs.metrics.enabled = enabled
        t0 = time.perf_counter()
        drive(g, adv, state, dt, steps)
        return time.perf_counter() - t0

    return loop


def _overhead_probe(g, adv, state, dt, steps: int, reps: int = REPS,
                    threshold: float = 1.05) -> list:
    """The telemetry overhead budget: :func:`overhead_ratio` of the step
    loop.  The JAX gate compares the medians of single loops; the port's
    loop is host-bound on the card, where the host's speed drifts by more
    than the budget between loops.  A failed measurement is confirmed by
    one re-measure, and only failing both fails the gate."""
    loop = overhead_loop(g, adv, state, dt, steps)
    drive(g, adv, state, dt, 2)  # first launches out of the timing
    ratio = overhead_ratio(loop, reps)
    if ratio > threshold:
        ratio = overhead_ratio(loop, reps)   # confirm before failing
    if ratio > threshold:
        return [f"telemetry overhead {ratio:.3f}x exceeds {threshold:.2f}x (the median "
                f"of {reps} rounds of off/on/on/off loops of {steps} steps, confirmed "
                "twice)"]
    return []


def _fresh_kernel_dir(workdir: str, device) -> None:
    """On the card: point the kernel build directory at a fresh one under
    ``workdir``, so this process compiles each library it launches (the
    ``compile`` phase and ``epoch.recompiles``), as a fresh process of the
    JAX package compiles its kernels."""
    if device.type == "cuda":
        from ..parallel.exec_cache import enable_persistent_cache

        enable_persistent_cache(os.path.join(workdir, "kernels"))


def required_series(device) -> tuple:
    """``(phases, counters, histograms)`` the gate requires on
    ``device``: the JAX gate's tuples, less ``CPU_ABSENT`` on the CPU."""
    if device.type == "cuda":
        return REQUIRED_PHASES, REQUIRED_NONZERO_COUNTERS, REQUIRED_HISTOGRAMS
    keep = lambda names: tuple(n for n in names if n not in CPU_ABSENT)
    return keep(REQUIRED_PHASES), keep(REQUIRED_NONZERO_COUNTERS), REQUIRED_HISTOGRAMS


def run_check(out_path: str, steps: int = 20, skip_overhead: bool = False,
              reps: int = REPS, threshold: float = 1.05,
              artifact_dir: str | None = None, device=None) -> list:
    """Run the workload and every probe on ``device`` (default CUDA,
    raising where there is none); returns failure strings (empty = pass)
    and writes ``telemetry.json`` to ``out_path`` (side files via
    :func:`artifact_path`).  On the CPU the probes run on one intra-op
    thread (restored after): the workload is ~900 cells, and more
    threads only add scheduling noise to the timed probes (the overhead
    budget, the cost model's calibration)."""
    import torch

    from ..grid import resolve_device

    device = resolve_device(device)
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _run_check(out_path, steps, skip_overhead, reps, threshold,
                          artifact_dir, device)
    finally:
        torch.set_num_threads(threads)


def _run_check(out_path, steps, skip_overhead, reps, threshold, artifact_dir,
               device) -> list:
    import shutil

    import numpy as np

    from .. import obs
    from ..grid import Grid
    from ..ops import LAUNCHES

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if artifact_dir is not None:
        os.makedirs(artifact_dir, exist_ok=True)
    failures: list = []
    obs.metrics.reset()
    obs.enable()
    obs.timeline.clear()
    obs.enable_timeline()
    workdir = tempfile.mkdtemp(prefix="dccrg_check_telemetry_")
    launched: dict = {}
    seconds: dict = {}

    def probe(name, fn, *args, **kw):
        """``fn(*args, **kw)``, its kernel launches (this process's, by
        ``ops.LAUNCHES`` key) and its wall seconds recorded under
        ``name``."""
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        launched[name] = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                          if v != before.get(k, 0)}
        return out

    try:
        _fresh_kernel_dir(workdir, device)
        g, adv, state, dt = build_workload(device)
        state = probe("workload", drive, g, adv, state, dt, steps)

        # checkpoint write and read-back (the checkpoint.* phases)
        spec = {"density": ((), np.float32)}
        ckpt = os.path.join(workdir, "telemetry_probe.dc")
        g.save_grid_data(state, ckpt, spec)
        g2, st2, _hdr = Grid.load_grid_data(ckpt, spec, device=device)
        if not np.allclose(np.asarray(g.get_cell_data(state, "density", g.get_cells())),
                           np.asarray(g2.get_cell_data(st2, "density", g.get_cells()))):
            failures.append("checkpoint round-trip altered the payload")

        failures += probe("resilience", _resilience_probe, g, state)
        failures += probe("churn", _churn_probe, g, dt)
        failures += probe("halo_backend", _halo_backend_probe, device)
        failures += probe("ensemble", _ensemble_probe, device)
        failures += probe("wide_halo", _wide_halo_probe, device)
        failures += probe("slo", _slo_probe, device)
        if not skip_overhead:
            # before the profiled and the cost rounds: their allocations'
            # collection pauses would land inside the timed reps
            failures += probe("overhead", _overhead_probe, g, adv, state, dt, steps,
                              reps=reps, threshold=threshold)
        failures += probe("live", _live_probe, g, adv, state, dt, steps, reps=reps,
                          threshold=threshold, skip_overhead=skip_overhead)
        failures += probe("cost", _cost_probe, device)
        failures += probe("elastic", _elastic_probe, g, state)
        failures += probe("fleet", _fleet_probe, device)
        failures += probe(
            "device_timeline", _device_timeline_probe, g, adv, state, dt, out_path,
            merged_path=artifact_path(out_path, ".merged_trace.json", artifact_dir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    report = g.report()
    phases, counters, histograms = required_series(device)
    for phase in phases:
        rec = report["phases"].get(phase)
        if not rec or rec["count"] < 1:
            failures.append(f"instrumented phase missing from report: {phase!r}")
    for counter in counters:
        if not any(v > 0 for v in report["counters"].get(counter, {}).values()):
            failures.append(f"counter {counter!r} recorded no value")
    for hist in histograms:
        if not any(h.get("count", 0) > 0
                   for h in report["histograms"].get(hist, {}).values()):
            failures.append(f"histogram {hist!r} recorded no samples: the SLO plane "
                            "lost its distribution")

    rep = obs.export_json(out_path, extra={
        "workload": f"advection 8^3 refined-ball, {steps} steps, {g.n_devices} slots "
                    f"on {device.type}",
        "n_cells": int(len(g.get_cells())),
        # the fleet's workers launch in their own processes, uncounted here
        "launches_by_probe": launched,
        "seconds_by_probe": seconds,
    })
    try:
        with open(out_path) as f:
            loaded = json.load(f)
        if loaded["phases"].keys() != rep["phases"].keys():
            failures.append("telemetry.json phase set differs from report")
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"telemetry.json unreadable: {e}")

    # the streaming exporter: explicit snapshots around real work, then
    # schema-validated like any stream
    stream_path = artifact_path(out_path, ".stream.jsonl", artifact_dir)
    s = obs.TelemetryStream(stream_path, period=3600.0, truncate=True,
                            extra={"workload": "check_telemetry probe"})
    s.write_snapshot(checkpoint="pre")
    state = drive(g, adv, state, dt, 2)
    s.write_snapshot(checkpoint="mid")
    s.stop(final=True)
    failures += [f"stream: {f}" for f in validate_stream(stream_path)]

    trace_path = artifact_path(out_path, ".trace.json", artifact_dir)
    if not obs.timeline.enabled or len(obs.timeline) == 0:
        failures.append("event timeline recorded no spans during probe")
    obs.export_chrome_trace(trace_path)
    failures += [f"trace: {f}" for f in validate_chrome_trace(trace_path)]
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(DEFAULT_TELEMETRY),
                    help="where to write telemetry.json (default "
                         "_telemetry/telemetry.json at the checkout's root)")
    ap.add_argument("--artifact-dir", default=None,
                    help="where the stream/trace/merged-trace side files land "
                         "(default: beside --out)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=REPS,
                    help="overhead-probe rounds (four step loops each: off, on, on, "
                         "off)")
    ap.add_argument("--threshold", type=float, default=1.05,
                    help="max allowed enabled/disabled step-loop ratio")
    ap.add_argument("--skip-overhead", action="store_true",
                    help="only check phase/counter completeness + export")
    ap.add_argument("--validate-stream", default=None, metavar="FILE",
                    help="only schema-validate an existing telemetry JSONL stream")
    ap.add_argument("--validate-trace", default=None, metavar="FILE",
                    help="only schema-validate an existing Chrome trace-event export")
    ap.add_argument("--validate-merged-trace", default=None, metavar="FILE",
                    help="only schema-validate an existing merged host+device (or "
                         "fleet) trace")
    ap.add_argument("--device", default=None,
                    help="where the workload runs (default: the CUDA card; 'cpu' "
                         "for the CPU)")
    args = ap.parse_args(argv)
    if args.validate_stream or args.validate_trace or args.validate_merged_trace:
        failures = []
        if args.validate_stream:
            counts: dict = {}
            failures += [f"stream: {f}"
                         for f in validate_stream(args.validate_stream, counts)]
            print(f"stream: {counts['lines']} lines, {counts['seq_gaps']} seq gaps, "
                  f"{counts['torn_tail']} torn tail, {counts['bad_lines']} bad lines",
                  file=sys.stderr)
        if args.validate_trace:
            failures += [f"trace: {f}" for f in validate_chrome_trace(args.validate_trace)]
        if args.validate_merged_trace:
            from ..obs.merge import validate_merged_trace

            failures += [f"merged: {f}"
                         for f in validate_merged_trace(args.validate_merged_trace)]
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        if not failures:
            print("telemetry stream/trace validation passed")
        return 1 if failures else 0
    from ..grid import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    failures = run_check(args.out, steps=args.steps, skip_overhead=args.skip_overhead,
                         reps=args.reps, threshold=args.threshold,
                         artifact_dir=args.artifact_dir, device=device)
    try:
        with open(args.out) as f:
            rec = json.load(f)
        for name, got in rec["launches_by_probe"].items():
            print(f"probe {name}: launches {got}, {rec['seconds_by_probe'][name]!r} s")
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"telemetry.json launch record unreadable: {e!r}")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(f"telemetry check passed; wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
