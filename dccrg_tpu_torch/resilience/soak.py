"""Crash, elastic and fleet soak harnesses: the end-to-end proofs of the
resilience layer and the serving fleet (the ``crash``, ``elastic`` and
``fleet`` subsystems of the JAX package's soak harness, ported).

    python -m dccrg_tpu_torch.resilience.soak crash --seeds 0 5 --device cpu
    python -m dccrg_tpu_torch.resilience.soak elastic --seeds 0 3 --device cuda
    python -m dccrg_tpu_torch.resilience.soak fleet --seeds 0 1 --device cpu

``crash`` (SIGKILL/resume convergence through the checkpoint lineage): a
child runs Game of Life and then advection on a refined grid with periodic
lineage commits while being killed — by injected SIGKILLs at commit
boundaries AND by the parent at random wall-clock times — and every
resume, possibly on another slot count, must converge to the
uninterrupted run's final state: Game of Life exactly, advection within
the cross-layout tolerance (1e-11 relative, f64).

``elastic`` (the supervised-rescale proof): a child runs the same two
workloads under AMR churn while performing seeded in-process grow/shrink
rescales (``resilience/elastic.py``), streaming a heartbeat the parent's
``Supervisor`` tails; an injected ``step.hang`` wedges the step loop (the
watchdog must detect the stall and escalate to a degraded rescale-down)
and an injected ``device.lost`` kills the worker (the supervisor relaunches
it on fewer slots from ``latest_valid()``).  The completed run must
converge to a fixed-slot reference (Game of Life exact, advection 1e-11),
and two fresh processes must then resume the lineage with the second
compiling nothing: ``epoch.recompiles`` sums to 0 in its report once the
kernel libraries are on disk (``cuda_build``).  On the CPU nothing is ever
compiled, so there the count is 0 by construction.

``fleet`` (the fault-tolerant gateway, ``serve/gateway.py``): a gateway
child runs supervised workers (``serve/worker.py``) over a crash-durable
journal and SIGKILLs one worker that holds work with more than 8 steps
left; the parent SIGKILLs the whole gateway once the journal shows that
worker's work redispatched and at least a quarter of the scenarios with
half their steps left, and relaunches it over the same journal (where one
more such worker is killed).  Both kills wait on journaled state, never on
a clock, so every victim holds work whatever the host's speed.  After the
fleet, a solo oracle steps every scenario alone in the parent (so the
fleet's latencies are measured with the card to itself).  Every accepted
scenario must retire exactly once, every result equal the oracle's (Game
of Life exactly, advection within 1e-11),
a flight-recorder dump must name a lost worker, no worker incarnation may
build a kernel (``epoch.recompiles`` 0 in its final stream) and the merged
worker streams must give a fleet p99.  After the seeds, the admission A/B
(:func:`fleet_admission_ab`, the JAX harness's ``_fleet_admission_ab``):
one real worker with ``DCCRG_GATEWAY_ADMISSION`` on, then off, a burst
tenant against a deadline tenant.  On, the burst is rejected at the door
and the deadline tenant retires on time; off, the burst is admitted and
the deadline tenant misses behind one burst round.

Children are this module run with an internal subcommand (``crash-child``,
``elastic-child``, ``proof-child``, ``fleet-gateway``) in a
fresh interpreter: they import
only this package, choose their slot count with ``initialize(n_devices=…)``
and run on ``--device`` (default CUDA; a child asked for CUDA where there
is none fails, it never falls back to the CPU).  Crash and elastic
children arm the flight recorder (``obs/flightrec.py``) at their workdir,
and the harnesses assert that every killed attempt left a schema-valid
postmortem naming the unit it was serving (:func:`check_flightrec_dump`).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the checkout that holds the package: children run from it
ROOT = pathlib.Path(__file__).resolve().parents[2]

#: the advection fields a lineage generation carries
ADV_FIELDS = ("density", "vx", "vy", "vz")
ADV_SPEC = {k: ((), np.float64) for k in ADV_FIELDS}


# ------------------------------------------------------------ children


def _atomic_save(path, arr):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _gol_grid(nd, device):
    from .. import Grid

    return (Grid().set_initial_length((10, 10, 1)).set_neighborhood_length(1)
            .set_periodic(True, True, False)
            .initialize(n_devices=nd, device=device))


def _adv_grid(rng, nd, device):
    """The soak's refined advection grid: 4^3 periodic, a fifth of the
    cells (drawn from ``rng``) refined once."""
    from .. import CartesianGeometry, Grid

    n = 4
    g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(CartesianGeometry, start=(0., 0., 0.),
                       level_0_cell_length=(1. / n,) * 3)
         .initialize(n_devices=nd, device=device))
    ids0 = np.sort(g.get_cells())
    for cid in rng.choice(ids0, size=max(1, len(ids0) // 5), replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    return g


def land_advection(g, spec_state):
    """(Re)build the model and its full state from a loaded or rescaled
    ``(grid, spec-field state)`` pair — the one landing path for fresh
    starts, resumes, rescales and churn rebuilds."""
    from .. import Advection

    ids = np.sort(g.get_cells())
    adv = Advection(g)
    s = adv.initialize_state()
    for f in ADV_FIELDS:
        s = adv.set_cell_data(s, f, ids, g.get_cell_data(spec_state, f, ids))
    return adv, g.update_copies_of_remote_neighbors(s)


def _fresh_advection(g, rng):
    """Seeded initial conditions, regenerated on every launch (``dt`` is
    taken from them, never from a resumed state)."""
    from .. import Advection

    ids = np.sort(g.get_cells())
    dens0 = rng.uniform(1, 2, len(ids))
    vels0 = {f: rng.uniform(-0.2, 0.2, len(ids)) for f in ("vx", "vy", "vz")}
    adv = Advection(g)
    s0 = adv.initialize_state()
    s0 = adv.set_cell_data(s0, "density", ids, dens0)
    for f in ("vx", "vy", "vz"):
        s0 = adv.set_cell_data(s0, f, ids, vels0[f])
    s0 = g.update_copies_of_remote_neighbors(s0)
    return adv, s0, 0.3 * adv.max_time_step(s0)


def crash_child(wd, seed, nd, total, every, device):
    """Game of Life, then advection, with a lineage commit every ``every``
    steps; each phase resumes from its lineage when one survives."""
    import atexit

    from .. import GameOfLife, obs
    from ..io.checkpoint import CheckpointError
    from ..obs import flightrec
    from .manager import CheckpointLineage

    obs.stream_to(os.path.join(wd, "child_stream.jsonl"), period=2.0,
                  extra={"subsystem": "crash", "seed": seed, "n_devices": nd})
    # the ring checkpoints itself to flightrec_<pid>.json in the workdir,
    # so even a SIGKILL mid-step leaves a postmortem naming the unit in
    # flight
    flightrec.recorder.arm(wd, period=0.5)
    # per-child timeline at exit (a SIGKILLed attempt leaves none)
    atexit.register(lambda: obs.export_chrome_trace(
        os.path.join(wd, "child_%d.trace.json" % os.getpid())))

    # ---- phase 1: Game of Life (exact across slot counts) -----------
    final = os.path.join(wd, "gol_final.npy")
    if not os.path.exists(final):
        rng = np.random.default_rng(seed)
        g = _gol_grid(nd, device)
        cells = g.get_cells()
        alive0 = cells[rng.random(len(cells)) < 0.35]
        lineage = CheckpointLineage(os.path.join(wd, "gol"), keep=3)
        try:
            g, s, hdr, gen = lineage.latest_valid(
                GameOfLife.SPEC, n_devices=nd, device=device)
            step = int(hdr)
            gol = GameOfLife(g)
            print("RESUMED gol gen=%d step=%d" % (gen, step), flush=True)
        except CheckpointError:
            gol = GameOfLife(g)
            s = gol.new_state(alive_cells=alive0)
            step = 0
            print("FRESH gol", flush=True)
        while step < total:
            flightrec.recorder.mark_unit("gol/%d" % step, tenant="soak",
                                         phase="gol", step=step)
            s = gol.run(s, 1)
            step += 1
            if step % every == 0:
                lineage.commit(g, s, GameOfLife.SPEC,
                               user_header=str(step).encode())
        _atomic_save(final, np.sort(gol.alive_cells(s)))

    # ---- phase 2: advection (within the cross-layout tolerance) -----
    final = os.path.join(wd, "adv_final.npy")
    if not os.path.exists(final):
        rng = np.random.default_rng(seed + 1)
        g = _adv_grid(rng, nd, device)
        ids = np.sort(g.get_cells())
        adv, s0, dt = _fresh_advection(g, rng)
        lineage = CheckpointLineage(os.path.join(wd, "adv"), keep=3)
        try:
            g2, s2, hdr, gen = lineage.latest_valid(
                ADV_SPEC, n_devices=nd, device=device)
            step = int(hdr)
            g = g2
            adv, s = land_advection(g, s2)
            print("RESUMED adv gen=%d step=%d" % (gen, step), flush=True)
        except CheckpointError:
            s = s0
            step = 0
            print("FRESH adv", flush=True)
        while step < total:
            flightrec.recorder.mark_unit("adv/%d" % step, tenant="soak",
                                         phase="adv", step=step)
            s = adv.step(s, dt)
            step += 1
            if step % every == 0:
                lineage.commit(g, s, ADV_SPEC, user_header=str(step).encode())
        _atomic_save(final, np.asarray(g.get_cell_data(s, "density", ids),
                                       np.float64))
    print("CRASH_CHILD_DONE", flush=True)


def elastic_child(wd, seed, nd, total, every, do_rescale, device):
    """Game of Life and advection under AMR churn with periodic lineage
    commits, seeded in-process grow/shrink rescales, a 0.5 s heartbeat and
    per-step fault hooks (``step.hang`` wedges the loop for the watchdog;
    ``device.lost`` exits 42 for the supervisor to relaunch degraded).  The
    churn and rescale schedules are pure functions of (seed, step), so every
    attempt — and the fixed-slot reference (``do_rescale`` 0, no faults) —
    walks the same structural history."""
    from .. import Advection, GameOfLife, obs
    from ..io.checkpoint import CheckpointError
    from ..obs import flightrec
    from . import inject
    from .elastic import DeviceLostError, rescale
    from .manager import CheckpointLineage

    hb = os.environ.get("DCCRG_ELASTIC_HEARTBEAT",
                        os.path.join(wd, "heartbeat.jsonl"))
    stream = obs.stream_to(hb, period=0.5,
                           extra={"subsystem": "elastic", "seed": seed})
    # every killed attempt (watchdog rescue, device loss, SIGKILL) leaves
    # flightrec_<pid>.json naming the step that was in flight
    flightrec.recorder.arm(wd, period=0.5)

    def schedules(phase):
        rng = np.random.default_rng(100_000 + seed * 7 + phase)
        n_r = min(3, max(1, total // 6))
        steps = np.sort(rng.choice(np.arange(2, total), size=n_r,
                                   replace=False))
        rescales = {int(s): int(rng.choice([1, 2, 4, 8])) for s in steps}
        churn = {int(s) for s in rng.choice(np.arange(1, total),
                                            size=min(3, total // 5),
                                            replace=False)}
        return rescales, churn

    def step_hooks(phase, step):
        # the unit is marked and checkpointed FIRST, so whichever fault
        # fires, the postmortem names this step as the victim (a step here
        # takes milliseconds, far less than the autodump period)
        flightrec.recorder.mark_unit("%s/%d" % (phase, step), tenant="soak",
                                     phase=phase, step=step)
        flightrec.recorder.checkpoint(force=True)
        stream.write_snapshot(phase=phase, step=step)
        inject.maybe_raise("device.lost", DeviceLostError, where="step")
        inject.maybe_hang("step.hang", seconds=600.0)

    def churn_refine(g, s, rng_tag):
        # the target comes from the SORTED leaf ids: every layout agrees
        ids = np.sort(g.get_cells())
        lvl = g.mapping.get_refinement_level(ids)
        cand = ids[lvl < g.mapping.max_refinement_level]
        if not len(cand):
            return g, s, False
        g.refine_completely(int(cand[rng_tag % len(cand)]))
        g.stop_refining()
        return g, g.remap_state(s), True

    # ---- phase 1: Game of Life (exact across counts and rescales) ----
    final = os.path.join(wd, "gol_final.npy")
    if not os.path.exists(final):
        rescales, _churn = schedules(0)
        rng = np.random.default_rng(seed)
        g = _gol_grid(nd, device)
        cells = g.get_cells()
        alive0 = cells[rng.random(len(cells)) < 0.35]
        lineage = CheckpointLineage(os.path.join(wd, "gol"), keep=3)
        try:
            g, s, hdr, gen = lineage.latest_valid(
                GameOfLife.SPEC, n_devices=nd, device=device)
            step = int(hdr)
            gol = GameOfLife(g)
            print("RESUMED gol gen=%d step=%d nd=%d" % (gen, step, nd),
                  flush=True)
        except CheckpointError:
            gol = GameOfLife(g)
            s = gol.new_state(alive_cells=alive0)
            step = 0
            print("FRESH gol nd=%d" % nd, flush=True)
        while step < total:
            step_hooks("gol", step)
            if do_rescale and step in rescales and rescales[step] != g.n_devices:
                r = rescale(g, s, GameOfLife.SPEC, rescales[step],
                            lineage=lineage, user_header=str(step).encode())
                g, s = r.grid, r.state
                gol = GameOfLife(g)
                print("RESCALED gol step=%d %d->%d" % (
                    step, r.n_devices_before, r.n_devices_after), flush=True)
            s = gol.run(s, 1)
            step += 1
            if step % every == 0:
                lineage.commit(g, s, GameOfLife.SPEC,
                               user_header=str(step).encode())
        _atomic_save(final, np.sort(gol.alive_cells(s)))

    # ---- phase 2: advection under AMR churn (1e-11 across layouts) ---
    final = os.path.join(wd, "adv_final.npy")
    if not os.path.exists(final):
        rescales, churn = schedules(1)
        rng = np.random.default_rng(seed + 1)
        g = _adv_grid(rng, nd, device)
        adv, s0, dt = _fresh_advection(g, rng)
        lineage = CheckpointLineage(os.path.join(wd, "adv"), keep=3)
        try:
            g, s2, hdr, gen = lineage.latest_valid(
                ADV_SPEC, n_devices=nd, device=device)
            step = int(hdr)
            adv, s = land_advection(g, s2)
            print("RESUMED adv gen=%d step=%d nd=%d" % (gen, step, nd),
                  flush=True)
        except CheckpointError:
            s = s0
            step = 0
            print("FRESH adv nd=%d" % nd, flush=True)
        while step < total:
            step_hooks("adv", step)
            if step in churn:
                g, s, did = churn_refine(g, s, 7919 * (step + 1))
                if did:
                    s = g.update_copies_of_remote_neighbors(s)
                    adv = Advection(g)
            if do_rescale and step in rescales and rescales[step] != g.n_devices:
                r = rescale(g, s, ADV_SPEC, rescales[step], lineage=lineage,
                            user_header=str(step).encode())
                g = r.grid
                adv, s = land_advection(g, r.state)
                print("RESCALED adv step=%d %d->%d" % (
                    step, r.n_devices_before, r.n_devices_after), flush=True)
            s = adv.step(s, dt)
            step += 1
            if step % every == 0:
                lineage.commit(g, s, ADV_SPEC, user_header=str(step).encode())
        ids_f = np.sort(g.get_cells())
        _atomic_save(final, np.asarray(
            g.get_cell_data(s, "density", ids_f), np.float64))
    print("ELASTIC_CHILD_DONE", flush=True)


def proof_child(wd, nd, out, device):
    """The warm-start proof: resume the elastic run's advection lineage on
    ``nd`` slots, step, run one deterministic churn cycle (rebuild, re-land,
    step), and report the grid's shape signature, the generation and the
    libraries this process compiled (``epoch.recompiles``) and loaded."""
    import torch

    from .. import Advection, cuda_build, obs
    from .manager import CheckpointLineage

    lineage = CheckpointLineage(os.path.join(wd, "adv"), keep=3)
    g, s2, _hdr, gen = lineage.latest_valid(ADV_SPEC, n_devices=nd,
                                            device=device)
    ids = np.sort(g.get_cells())
    adv, s = land_advection(g, s2)
    dt = 0.25 * adv.max_time_step(s)
    s = adv.step(s, dt)
    lvl = g.mapping.get_refinement_level(ids)
    cand = ids[lvl < g.mapping.max_refinement_level]
    if len(cand):
        g.refine_completely(int(cand[len(cand) // 2]))
        g.stop_refining()
        s = g.update_copies_of_remote_neighbors(g.remap_state(s))
        adv = Advection(g)
        s = adv.step(s, dt)
    if s["density"].is_cuda:
        torch.cuda.synchronize()
    rep = obs.metrics.report()
    rec = {
        "signature": repr(g.shape_signature()),
        "generation": gen,
        "device": str(g.device),
        "recompiles": int(sum(
            rep["counters"].get("epoch.recompiles", {}).values())),
        "libraries": sorted(cuda_build._libs),
    }
    with open(out, "w") as f:
        json.dump(rec, f)
    print("PROOF_CHILD_DONE", json.dumps(rec), flush=True)


# ------------------------------------------------------------- harnesses


def _launch(workdir, kind, argv, env_extra=None, log_name="child.log"):
    """Start ``python -m dccrg_tpu_torch.resilience.soak <kind> argv...``
    from the checkout with its output appended to ``workdir/log_name``."""
    env = dict(os.environ)
    env.pop("DCCRG_FAULT", None)
    env.update(env_extra or {})
    log = open(os.path.join(workdir, log_name), "a")
    p = subprocess.Popen(
        [sys.executable, "-m", "dccrg_tpu_torch.resilience.soak", kind]
        + [str(a) for a in argv],
        cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT, env=env,
    )
    return p, log


def _tail(path, n=2000):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def check_flightrec_dump(workdir: str, context: str,
                         require_inflight: bool = True) -> list:
    """Harness-side black-box assertion: a killed child must have left a
    parseable ``flightrec_*.json`` postmortem in its workdir naming the
    unit(s) it had in flight.  Returns failure strings.

    ``require_inflight=False`` relaxes the victim-naming requirement to
    "only if the dump shows stepping ever began" (any ``unit`` event in
    the ring) — the crash harness kills at RANDOM wall-clock times that
    can land in the sliver between arming and the first step."""
    import glob

    from ..obs.flightrec import validate_flightrec

    files = glob.glob(os.path.join(workdir, "flightrec_*.json"))
    if not files:
        return [f"{context}: killed child left no flight-recorder dump"]
    newest = max(files, key=os.path.getmtime)
    name = os.path.basename(newest)
    fails = [f"{context}: {name}: {f}" for f in validate_flightrec(newest)]
    if fails:
        return fails
    with open(newest) as f:
        rec = json.load(f)
    stepped = any(ev.get("kind") == "unit" for ev in rec.get("events", []))
    if (require_inflight or stepped) and not rec.get("in_flight"):
        return [f"{context}: postmortem {name} names no in-flight request"]
    return []


def _open_stream(stream_dir, name, extra):
    if not stream_dir:
        return None
    from ..obs.stream import TelemetryStream

    os.makedirs(stream_dir, exist_ok=True)
    return TelemetryStream(os.path.join(stream_dir, name), truncate=True,
                           extra=extra)


def _converged(ref, wd):
    """Game of Life exactly, advection within 1e-11 relative of the
    reference's finals; raises AssertionError otherwise."""
    np.testing.assert_array_equal(np.load(os.path.join(wd, "gol_final.npy")),
                                  np.load(os.path.join(ref, "gol_final.npy")))
    np.testing.assert_allclose(np.load(os.path.join(wd, "adv_final.npy")),
                               np.load(os.path.join(ref, "adv_final.npy")),
                               rtol=1e-11, atol=0)


def run_crash(lo: int, hi: int, stream_dir: str | None = None,
              total_steps: int = 24, every: int = 3,
              device: str = "cuda") -> bool:
    """The crash/resume proof harness.  Per seed:

    1. an uninterrupted reference child runs to completion;
    2. a crash child runs the same workload with lineage checkpoints
       while being killed — even attempts arm an injected SIGKILL at a
       random commit boundary plus occasional torn writes
       (``DCCRG_FAULT``), odd attempts get SIGKILLed by THIS process at
       a random wall-clock moment (which can land mid-write or
       mid-manifest-rewrite — the genuinely torn cases); each relaunch
       resumes from ``latest_valid()`` on a possibly different slot count;
    3. once a launch completes, the final states must match the
       reference: Game of Life exactly, advection to the 1e-11
       cross-layout tolerance.

    Every attempt's outcome (exit status, kill mode, which generation the
    resume picked up) is appended to the streaming telemetry JSONL in
    ``stream_dir``."""
    stream = _open_stream(stream_dir, f"crash_{lo}_{hi}.jsonl",
                          {"subsystem": "crash", "seeds": [lo, hi]})

    def record(**kw):
        if stream is not None:
            stream.write_snapshot(**kw)

    def launch(workdir, seed, nd, env_extra=None):
        return _launch(workdir, "crash-child",
                       [workdir, seed, nd, total_steps, every, device],
                       env_extra)

    def resumes_of(workdir):
        return re.findall(r"(?:RESUMED|FRESH) [^\n]*",
                          _tail(os.path.join(workdir, "child.log"), 1 << 20))[-4:]

    nd_cycle = (2, 1, 4)
    max_attempts = 8
    ok_all = True
    for seed in range(lo, hi):
        rng = np.random.default_rng(10_000 + seed)
        tmp = tempfile.mkdtemp(prefix=f"dccrg_crash_{seed}_")
        try:
            # 1. uninterrupted reference
            ref = os.path.join(tmp, "ref")
            os.makedirs(ref)
            p, log = launch(ref, seed, int(rng.choice(nd_cycle)))
            rc = p.wait()
            log.close()
            if rc != 0:
                print(f"crash seed {seed}: reference run failed rc={rc}")
                print(_tail(os.path.join(ref, "child.log")))
                record(seed=seed, outcome="reference-failed", exit=rc)
                ok_all = False
                continue

            # 2. crash/resume until a launch completes
            wd = os.path.join(tmp, "crash")
            os.makedirs(wd)
            rc = -1
            for attempt in range(max_attempts):
                nd = nd_cycle[attempt % len(nd_cycle)]
                last = attempt == max_attempts - 1
                env_extra, kill_mode = {}, "none"
                if not last and attempt % 2 == 0:
                    kill_mode = "inject-sigkill"
                    env_extra["DCCRG_FAULT"] = (
                        f"sigkill.post_commit:0.6:{seed * 97 + attempt}:1"
                        f":{int(rng.integers(0, 4))}"
                        f",checkpoint.torn_write:0.07:{seed * 31 + attempt}"
                    )
                elif not last:
                    kill_mode = "parent-kill"
                p, log = launch(wd, seed, nd, env_extra)
                if kill_mode == "parent-kill":
                    try:
                        p.wait(timeout=float(rng.uniform(2.0, 10.0)))
                    except subprocess.TimeoutExpired:
                        p.kill()
                try:
                    # hang guard: a wedged child is killed and recorded
                    rc = p.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                    kill_mode += "+hang-guard"
                log.close()
                record(seed=seed, attempt=attempt, n_devices=nd,
                       kill=kill_mode, exit=rc, resumes=resumes_of(wd))
                if rc == 0:
                    break
                # every killed attempt that reached the workload must have
                # left its black box (random-time kills can land before
                # arming — resumes_of is the evidence the child got that far)
                if resumes_of(wd):
                    probs = check_flightrec_dump(
                        wd, f"crash seed {seed} attempt {attempt}",
                        require_inflight=False)
                    for msg in probs:
                        print(f"  FLIGHTREC: {msg}")
                    if probs:
                        record(seed=seed, attempt=attempt,
                               outcome="flightrec-missing")
                        ok_all = False
            if rc != 0:
                print(f"crash seed {seed}: no attempt completed "
                      f"(last rc={rc})")
                print(_tail(os.path.join(wd, "child.log")))
                record(seed=seed, outcome="never-completed", exit=rc)
                ok_all = False
                continue

            # 3. convergence against the reference
            try:
                _converged(ref, wd)
            except AssertionError as e:
                print(f"crash seed {seed}: DIVERGED after resume: "
                      f"{str(e)[:200]}")
                record(seed=seed, outcome="diverged")
                ok_all = False
                continue
            record(seed=seed, outcome="ok", attempts=attempt + 1)
            print(f"crash seed {seed}: OK after {attempt + 1} attempt(s)")
        finally:
            if stream_dir:
                import glob

                for i, t in enumerate(sorted(glob.glob(
                        os.path.join(tmp, "*", "child_*.trace.json")))):
                    shutil.copy(t, os.path.join(
                        stream_dir, f"crash_{seed}_{i}.trace.json"))
            shutil.rmtree(tmp, ignore_errors=True)
    if stream is not None:
        stream.stop(final=True)
    print(f"{'crash':12s} [{lo},{hi}): {'OK' if ok_all else 'FAIL'}")
    return ok_all


def wait_first_step_beat(p, hb_path, timeout=300.0) -> bool:
    """Wait until the child's heartbeat stream holds a line with a ``step``
    marker (its first step), or it exits, or ``timeout`` passes.  Returns
    whether a step beat landed.  Start-up (interpreter, CUDA context, grid
    build) is not a stall: a supervisor's stall window starts here."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout and p.poll() is None:
        try:
            with open(hb_path, "rb") as f:
                for line in f:
                    if line.endswith(b"\n") and b'"step":' in line:
                        return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def supervise(p, hb_path, stall_after, timeout=600.0):
    """Poll the child's heartbeat from its first step until it exits or
    the watchdog decides; returns ``(outcome, returncode, actions)`` where
    outcome is ``exited`` | ``rescale_down`` | ``restart`` | ``timeout`` and
    ``actions`` lists the ladder's ``(action, reason, unix time)`` decisions.
    The child is killed (and reaped) on any decision but a warning."""
    from .supervisor import HeartbeatMonitor, Supervisor

    wait_first_step_beat(p, hb_path)
    sup = Supervisor(HeartbeatMonitor(hb_path, stall_after_s=stall_after),
                     child_alive=lambda: p.poll() is None)
    actions = []
    t0 = time.monotonic()
    while True:
        time.sleep(0.1)
        if p.poll() is not None:
            if p.returncode != 0:
                # count the dead-child escalation in THIS process's
                # registry (the child's own counters died with it)
                sup.poll()
            return "exited", p.returncode, actions
        act = sup.poll()
        if act["action"] is not None:
            actions.append((act["action"], act["reason"], time.time()))
        if act["action"] in ("rescale_down", "restart"):
            outcome = act["action"]
        elif time.monotonic() - t0 > timeout:
            outcome = "timeout"
        else:
            continue
        p.kill()
        p.wait()
        return outcome, None, actions


#: seconds without progress after which the elastic harness's watchdog
#: calls a child stalled: far above an honest step of its small workloads
#: (milliseconds), and the stall window opens only at the first step beat
STALL_AFTER_S = 5.0


def run_elastic(lo: int, hi: int, stream_dir: str | None = None,
                total_steps: int = 18, every: int = 3,
                device: str = "cuda") -> bool:
    """The elastic-fleet proof harness.  Per seed:

    1. a fixed-slot reference child runs the workload to completion
       (same seeded AMR-churn schedule, no rescales, no faults);
    2. an elastic run: the child performs seeded in-process grow/shrink
       rescales while this process's :class:`Supervisor` tails its 0.5 s
       heartbeat stream (from its first step; ``STALL_AFTER_S`` seconds
       without progress is a stall) — attempt 0 arms an injected
       ``step.hang`` (the watchdog must detect the stall and escalate
       warn → rescale-down: the child is killed and relaunched DEGRADED on
       half the slots), attempt 1 arms ``device.lost`` (the child exits
       42; the supervisor's dead-child path relaunches it on fewer slots
       from ``latest_valid()``), later attempts run clean; every relaunch
       resumes from the lineage;
    3. the completed run's final states must match the reference — Game
       of Life exactly, advection to the 1e-11 cross-layout tolerance;
    4. the warm-start proof: two fresh processes resume the final lineage
       and run one churn cycle; the second must land on the first's shape
       signature having compiled nothing (``epoch.recompiles`` == 0).
    """
    stream = _open_stream(stream_dir, f"elastic_{lo}_{hi}.jsonl",
                          {"subsystem": "elastic", "seeds": [lo, hi]})

    def record(**kw):
        if stream is not None:
            stream.write_snapshot(**kw)

    nd_ref = 2
    max_attempts = 8
    ok_all = True
    for seed in range(lo, hi):
        tmp = tempfile.mkdtemp(prefix=f"dccrg_elastic_{seed}_")
        try:
            # 1. fixed-slot reference (no rescales, no faults)
            ref = os.path.join(tmp, "ref")
            os.makedirs(ref)
            p, log = _launch(ref, "elastic-child",
                             [ref, seed, nd_ref, total_steps, every, 0, device])
            rc = p.wait()
            log.close()
            if rc != 0:
                print(f"elastic seed {seed}: reference failed rc={rc}")
                print(_tail(os.path.join(ref, "child.log")))
                record(seed=seed, outcome="reference-failed", exit=rc)
                ok_all = False
                continue

            # 2. supervised elastic run with injected hang + device loss
            wd = os.path.join(tmp, "elastic")
            os.makedirs(wd)
            nd = 4
            rc = -1
            for attempt in range(max_attempts):
                hb = os.path.join(wd, f"heartbeat_{attempt}.jsonl")
                env_extra = {"DCCRG_ELASTIC_HEARTBEAT": hb}
                fault = "none"
                if attempt == 0:
                    # wedge the step loop a few steps in: only the
                    # heartbeat watchdog can see this failure
                    fault = "step.hang"
                    env_extra["DCCRG_FAULT"] = \
                        f"step.hang:1:{seed}:1:{2 + seed % 3}"
                elif attempt == 1:
                    fault = "device.lost"
                    env_extra["DCCRG_FAULT"] = \
                        f"device.lost:1:{seed}:1:{3 + seed % 4}"
                p, log = _launch(wd, "elastic-child",
                                 [wd, seed, nd, total_steps, every, 1, device],
                                 env_extra)
                outcome, rc, actions = supervise(p, hb, STALL_AFTER_S)
                log.close()
                for action, reason, _t in actions:
                    print(f"    watchdog: {action} ({reason})", flush=True)
                record(seed=seed, attempt=attempt, n_devices=nd,
                       fault=fault, outcome=outcome, exit=rc)
                print(f"  attempt {attempt} nd={nd} fault={fault}: "
                      f"{outcome} rc={rc}", flush=True)
                if outcome == "exited" and rc == 0:
                    break
                # a killed/faulted attempt must leave its black box naming
                # the step it was serving — the hang wedges AFTER the unit
                # is marked and the checkpoint ticks every 0.5 s
                probs = check_flightrec_dump(
                    wd, f"elastic seed {seed} attempt {attempt}")
                for msg in probs:
                    print(f"  FLIGHTREC: {msg}")
                if probs:
                    record(seed=seed, attempt=attempt,
                           outcome="flightrec-missing")
                    ok_all = False
                # degraded relaunch on fewer slots after a watchdog
                # rescale-down or a device loss (exit 42); a restart keeps
                # the count
                if outcome == "rescale_down" or rc == 42:
                    nd = max(1, nd // 2)
            if rc != 0:
                print(f"elastic seed {seed}: no attempt completed "
                      f"(last rc={rc})")
                print(_tail(os.path.join(wd, "child.log")))
                record(seed=seed, outcome="never-completed", exit=rc)
                ok_all = False
                continue

            # 3. convergence against the fixed-slot reference
            try:
                _converged(ref, wd)
            except AssertionError as e:
                print(f"elastic seed {seed}: DIVERGED from fixed-slot "
                      f"reference: {str(e)[:300]}")
                record(seed=seed, outcome="diverged")
                ok_all = False
                continue

            # 4. fresh-process warm start: the second compiles nothing
            proofs = []
            proof_ok = True
            for i in range(2):
                out = os.path.join(wd, f"proof_{i}.json")
                p, log = _launch(wd, "proof-child", [wd, nd, out, device],
                                 log_name=f"proof_{i}.log")
                prc = p.wait()
                log.close()
                if prc != 0:
                    print(f"elastic seed {seed}: proof child {i} rc={prc}")
                    print(_tail(os.path.join(wd, f"proof_{i}.log"), 1500))
                    proof_ok = False
                    break
                with open(out) as f:
                    proofs.append(json.load(f))
            if proof_ok:
                a, b = proofs
                if b["signature"] != a["signature"]:
                    print(f"elastic seed {seed}: warm-start signature "
                          f"drifted: {a['signature']} -> {b['signature']}")
                    proof_ok = False
                elif b["recompiles"] != 0:
                    print(f"elastic seed {seed}: warm start NOT warm: "
                          f"recompiles={b['recompiles']} "
                          f"libraries={b['libraries']}")
                    proof_ok = False
            record(seed=seed,
                   outcome="ok" if proof_ok else "warm-start-failed",
                   attempts=attempt + 1, proofs=proofs)
            if not proof_ok:
                ok_all = False
                continue
            print(f"elastic seed {seed}: OK after {attempt + 1} "
                  f"attempt(s); warm start recompiles=0 "
                  f"(libraries loaded: {proofs[1]['libraries']})")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if stream is not None:
        stream.stop(final=True)
    print(f"{'elastic':12s} [{lo},{hi}): {'OK' if ok_all else 'FAIL'}")
    return ok_all


# ------------------------------------------------------------------ fleet


def fleet_specs(seed: int, n: int | None = None) -> list:
    """The per-seed fleet workload (the JAX harness's ``_fleet_specs``):
    four 8x8 Game of Life and two 4^3 advection scenarios of 48 steps, or
    with ``n`` a seeded mix of ``n`` scenarios at ``build_scenario``'s
    sizes (Game of Life 10x10, advection 4^3)."""
    if n is None:
        specs = [{"sid": f"g{i}", "model": "gol", "n": 8,
                  "seed": seed * 100 + i, "steps": 48, "tenant": "fleet"}
                 for i in range(4)]
        specs += [{"sid": f"a{i}", "model": "advection", "n": 4,
                   "seed": seed * 100 + 50 + i, "steps": 48,
                   "tenant": "fleet"} for i in range(2)]
        return specs
    kinds = np.random.default_rng(seed).choice(["gol", "advection"], size=n)
    return [{"sid": f"{k[0]}{i}", "model": str(k), "seed": seed * 1000 + i,
             "steps": 48, "tenant": "fleet"} for i, k in enumerate(kinds)]


def fleet_solo_refs(specs, refdir, nd, device):
    """The oracle: every scenario of ``specs`` stepped alone (no chunking,
    no cohort peers), its final state parked as
    ``refdir/result_<sid>.npz``.  (The JAX harness runs it in a child
    beside the fleet and then steps the cohort widths a fleet reaches, to
    fill the shared compilation cache; the port compiles no cohort body,
    and runs it after the fleet.)"""
    from ..serve.ensemble import Ensemble
    from ..serve.worker import build_scenario, park_state

    os.makedirs(refdir, exist_ok=True)
    ens = Ensemble()
    for spec in specs:
        b = build_scenario(spec, nd, device)
        t = ens.submit(b["model"], b["state"], steps=int(spec["steps"]),
                       dt=b["dt"])
        ens.run()
        park_state(b, t.result, os.path.join(refdir, f"result_{spec['sid']}.npz"),
                   int(spec["steps"]))


def fleet_gateway_child(wd, specs_path, n_workers, nd, seed, n_kills,
                        done_path, device):
    """One killable gateway incarnation: real worker processes on ``nd``
    slots of ``device`` each, a real journal, ``n_kills`` seeded SIGKILLs
    of workers that hold work with more than 8 journaled steps left, once
    watermarks flow; writes ``done_path`` when every accepted scenario
    retired."""
    import random

    from .. import obs
    from ..obs.flightrec import recorder as flightrec
    from ..obs.registry import metrics
    from ..serve import Gateway, WorkerHandle

    metrics.enabled = True
    obs.stream_to(os.path.join(wd, "gateway.stream.jsonl"), period=1.0,
                  truncate=True, extra={"role": "gateway"})
    flightrec.arm(wd, period=1.0)
    workers = [WorkerHandle(f"w{i}", os.path.join(wd, f"w{i}"), nd,
                            device=device) for i in range(n_workers)]
    for w in workers:
        w.start()
    gw = Gateway(os.path.join(wd, "journal.jsonl"), workers)
    with open(specs_path) as f:
        for spec in json.load(f):
            ok, why = gw.submit(spec)   # idempotent across incarnations
            if not ok:
                print("REJECTED", spec["sid"], why, flush=True)
    rng = random.Random(seed * 7919 + n_kills)
    kills, last_kill_tick, ticks = 0, -10**9, 0
    compacted, moved, moved_tick = 0, 0, -10**9
    deadline = time.monotonic() + 540.0
    while True:
        st = gw.tick(restart_lost=True)
        ticks += 1
        if len(gw.redispatches) != moved:
            moved, moved_tick = len(gw.redispatches), ticks
        # compact every 40 ticks, but leave a redispatch in the WAL for
        # 20 ticks: the harness reads it there
        if ticks - compacted >= 40 and ticks - moved_tick > 20:
            gw.journal.checkpoint()
            compacted = ticks
        # kill only after this incarnation saw watermark progress, and
        # only a victim with more than 8 steps left: the redispatch must
        # move real work
        if kills < n_kills and ticks - last_kill_tick > 60 and gw._last_wm:
            def meaty(w):
                if w.lost or not w.alive():
                    return False
                for sid in gw.journal.in_flight(w.wid):
                    done = gw.journal.watermark.get(sid, {}).get("step", 0)
                    if int(gw.journal.accepted[sid].get("steps", 0)) - done > 8:
                        return True
                return False
            victims = sorted((w for w in workers if meaty(w)), key=lambda w: w.wid)
            if victims:
                v = rng.choice(victims)
                print("KILLING", v.wid, "generation", v.generation, flush=True)
                v.kill()
                kills += 1
                last_kill_tick = ticks
        if st["outstanding"] == 0:
            break
        if time.monotonic() > deadline:
            print("FLEET GATEWAY TIMEOUT", st, flush=True)
            gw.close()
            sys.exit(3)
        time.sleep(0.05)
    gw.journal.checkpoint()
    # every live incarnation (a replacement included) heartbeats before
    # the drain, so its final stream carries its counters
    t_end = time.monotonic() + 60.0
    while time.monotonic() < t_end and not all(
            os.path.exists(w.stream) and os.path.getsize(w.stream) > 0
            for w in workers if w.alive()):
        gw.tick(restart_lost=False)
        time.sleep(0.1)
    rep = metrics.report()["counters"]
    state = {
        "accepted": sorted(gw.journal.accepted),
        "retired": sorted(gw.journal.retired),
        "rejected": gw.journal.rejected,
        "kills": kills,
        "generations": {w.wid: w.generation for w in workers},
        "redispatches": gw.redispatches,
        "counters": {k: v for k, v in rep.items() if k.startswith("gateway.")},
    }
    tmp = done_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, sort_keys=True, indent=1)
    os.replace(tmp, done_path)
    gw.drain(timeout_s=30.0)
    gw.close()
    print("FLEET DRAINED", len(state["retired"]), "retired", flush=True)


def _journal_progress(journal: str, seen: set) -> tuple:
    """What a live fleet's journal shows, read without writing: the
    snapshot, then the WAL (a torn last line is skipped).  ``seen``, kept
    across calls, gathers the WAL's event kinds, which a compaction drops.
    Returns (sid -> watermark step, retired sids)."""
    wm, retired = {}, set()
    try:
        with open(journal + ".snap.json") as f:
            body = json.load(f).get("state") or {}
        wm = {sid: int(v.get("step", 0))
              for sid, v in (body.get("watermark") or {}).items()}
        retired = set(body.get("retired") or [])
    except (OSError, ValueError, AttributeError):
        pass
    try:
        with open(journal, "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        lines = []
    for ln in lines:
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        ev, sid = rec.get("ev"), rec.get("sid")
        seen.add(ev)
        if ev == "watermark":
            wm[sid] = max(wm.get(sid, 0), int(rec.get("step", 0)))
        elif ev == "retired":
            retired.add(sid)
    return wm, retired


def _wait(p, timeout):
    t0 = time.monotonic()
    while p.poll() is None:
        if time.monotonic() - t0 > timeout:
            p.kill()
            p.wait()
            return None
        time.sleep(0.25)
    return p.returncode


# ------------------------------------------------------- admission A/B

#: the deadline tenant's and the burst's deadline budgets (s), the JAX
#: harness's
AB_DL_DEADLINE_S, AB_BURST_DEADLINE_S = 5.0, 2.0
#: one off-mode burst round lasts at least this many deadline-tenant
#: deadlines: the chunk is sized from the warm-up's measured service rate
AB_ROUND_DEADLINES = 3.0
#: the warm-up scenarios (the JAX harness's shapes; steps cut from its
#: 4000 / 2000: the port builds no kernel at run time, so a short warm-up
#: already prices stepping)
AB_WARM = ({"sid": "warm-b", "model": "advection", "n": 4, "seed": 7,
            "steps": 400, "tenant": "burst"},
           {"sid": "warm-d", "model": "gol", "n": 8, "seed": 7,
            "steps": 200, "tenant": "dl"})
#: park chunk of the on-mode worker (the warm-ups retire in one round)
AB_WARM_CHUNK = 20000


def admission_ab_chunk(rate: float) -> int:
    """The burst chunk for a burst tenant served at ``rate`` member-steps a
    second: one off-mode round of it lasts ``AB_ROUND_DEADLINES`` deadline
    budgets of the deadline tenant."""
    if not rate > 0.0:
        raise ValueError(f"no measured burst service rate ({rate!r})")
    return max(1, int(np.ceil(AB_ROUND_DEADLINES * AB_DL_DEADLINE_S * float(rate))))


def _tenant_count(name: str, tenant: str) -> float:
    from ..obs.registry import metrics

    rep = metrics.report()["counters"].get(name, {})
    return sum(v for k, v in rep.items() if k == f"tenant={tenant}")


def admission_ab_round(gw, drive, chunk: int):
    """One mode's burst round on a warmed gateway ``gw``: four burst
    advection submissions of ``2 * chunk`` steps with the burst's deadline,
    then the deadline tenant's ``dl0`` (Game of Life, 8 steps), which must
    be admitted; ``drive(sids)`` runs the fleet until they retire (False:
    it gave up).  Returns ``{"rejected", "miss", "ok"}`` (the deadline
    tenant's verdict counters' increments), or None where ``dl0`` was
    rejected or never retired."""
    rejected = 0
    for i in range(4):
        ok, _ = gw.submit({"sid": f"b{i}", "model": "advection", "n": 4,
                           "seed": 100 + i, "steps": 2 * int(chunk),
                           "tenant": "burst", "deadline_s": AB_BURST_DEADLINE_S})
        rejected += 0 if ok else 1
    miss0 = _tenant_count("gateway.deadline_miss", "dl")
    ok0 = _tenant_count("gateway.deadline_ok", "dl")
    ok, why = gw.submit({"sid": "dl0", "model": "gol", "n": 8, "seed": 9,
                         "steps": 8, "tenant": "dl",
                         "deadline_s": AB_DL_DEADLINE_S})
    if not ok:
        print(f"fleet A/B: deadline tenant rejected ({why}): it must always be admitted")
        return None
    if not drive(["dl0"]):
        print("fleet A/B: deadline tenant never retired")
        return None
    return {"rejected": rejected,
            "miss": _tenant_count("gateway.deadline_miss", "dl") - miss0,
            "ok": _tenant_count("gateway.deadline_ok", "dl") - ok0}


def admission_ab_verdict(on, off) -> list:
    """The A/B's failures (empty: it passed): with admission on, at least
    one burst rejection and the deadline tenant on time; with it off, no
    rejection and at least one deadline miss."""
    if on is None or off is None:
        return ["a mode failed to complete"]
    fails = []
    if on["rejected"] < 1:
        fails.append(f"admission on admitted the whole burst ({on}): it is not enforcing")
    if on["miss"] != 0 or on["ok"] != 1:
        fails.append(f"the deadline tenant missed with admission on ({on})")
    if off["rejected"] != 0:
        fails.append(f"DCCRG_GATEWAY_ADMISSION=0 rejected submissions ({off})")
    if off["miss"] < 1:
        fails.append(f"the deadline tenant met its deadline behind the admitted burst "
                     f"({off}): starvation did not reproduce, the A/B proves nothing")
    return fails


def fleet_admission_ab(record=None, n_devices: int = 1, device: str = "cuda",
                       budget_s: float = 120.0):
    """The enforced-admission starvation A/B (the JAX harness's
    ``_fleet_admission_ab``): one real worker (``serve/gateway.py::
    WorkerHandle``) a mode, admission on and then off.  Each mode warms both
    tenants' service rates on real retirements (``AB_WARM``); the on mode's
    burst rate sizes the chunk (:func:`admission_ab_chunk`), which is the
    off-mode worker's park chunk, so the deadline tenant queues behind one
    burst round of at least ``AB_ROUND_DEADLINES`` of its deadlines.  The
    environment is restored in a ``finally``.  Returns ``(ok, report)``:
    report holds each mode's counts, the chunk, the rate it came from and
    the seconds; ``record`` (a stream's writer, or None) gets it too."""
    from ..obs.registry import metrics
    from ..serve import Gateway, WorkerHandle

    t_ab = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dccrg_fleet_ab_")
    keys = ("DCCRG_GATEWAY_ADMISSION", "DCCRG_GATEWAY_PARK_EVERY",
            "DCCRG_GATEWAY_STALL_S", "DCCRG_GATEWAY_QUEUE_MAX", "DCCRG_SLO_QUEUE_S")
    saved = {k: os.environ.get(k) for k in keys}
    was_enabled = metrics.enabled
    report = {"chunk": None, "rate": None}

    def one_run(tag, admission, chunk):
        os.environ["DCCRG_GATEWAY_ADMISSION"] = "1" if admission else "0"
        os.environ["DCCRG_GATEWAY_PARK_EVERY"] = str(chunk)
        wd = os.path.join(tmp, tag)
        w = WorkerHandle("w0", os.path.join(wd, "w0"), n_devices, device=device)
        w.start()
        gw = Gateway(os.path.join(wd, "journal.jsonl"), [w])
        t_end = t_ab + budget_s

        def drive(sids):
            while set(sids) - gw.journal.retired:
                gw.tick()
                if time.perf_counter() > t_end:
                    return False
                time.sleep(0.02)
            return True

        try:
            for spec in AB_WARM:
                gw.submit(dict(spec))
            if not drive([spec["sid"] for spec in AB_WARM]):
                print(f"fleet A/B ({tag}): the warm-up never retired")
                return None
            if report["chunk"] is None:
                report["rate"] = gw.tracker.rate("burst")
                report["chunk"] = admission_ab_chunk(report["rate"])
            return admission_ab_round(gw, drive, report["chunk"])
        finally:
            gw.close()   # abandoned burst members die with the worker

    try:
        os.environ["DCCRG_GATEWAY_STALL_S"] = "600"
        os.environ["DCCRG_GATEWAY_QUEUE_MAX"] = "64"
        os.environ.pop("DCCRG_SLO_QUEUE_S", None)
        metrics.enabled = True
        t0 = time.perf_counter()
        report["on"] = one_run("on", True, AB_WARM_CHUNK)
        report["on_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["off"] = (one_run("off", False, report["chunk"])
                         if report["chunk"] is not None else None)
        report["off_s"] = time.perf_counter() - t0
    finally:
        metrics.enabled = was_enabled
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_ab
    report["failures"] = admission_ab_verdict(report["on"], report["off"])
    if record is not None:
        record(phase="admission-ab", **report)
    for msg in report["failures"]:
        print(f"fleet A/B: {msg}")
    on, off = report["on"] or {}, report["off"] or {}
    print(f"fleet A/B: chunk {report['chunk']} from a burst rate of {report['rate']!r} "
          f"member-steps/s; ON rejected={on.get('rejected')} dl_miss={on.get('miss')} "
          f"dl_ok={on.get('ok')} | OFF rejected={off.get('rejected')} "
          f"dl_miss={off.get('miss')} dl_ok={off.get('ok')}; {report['seconds']:.1f} s",
          flush=True)
    return not report["failures"], report


def run_fleet(lo: int, hi: int, stream_dir: str | None = None,
              n_workers: int = 2, n_devices: int = 1, device: str = "cuda",
              n_specs: int | None = None, report: dict | None = None) -> bool:
    """The fleet proof, per seed (see the module docstring); ``n_specs``
    picks :func:`fleet_specs`' seeded mix.  ``report`` (a dict), when
    given, receives each seed's numbers: retirements, kills, generations,
    redispatches, the fleet p99 and the phase's seconds; and under
    ``"admission_ab"`` the A/B's report (:func:`fleet_admission_ab`), run
    after the seeds."""
    import glob

    from ..obs import slo as obs_slo
    from ..obs.flightrec import validate_flightrec

    stream = _open_stream(stream_dir, f"fleet_{lo}_{hi}.jsonl",
                          {"subsystem": "fleet", "seeds": [lo, hi]})

    def record(**kw):
        if stream is not None:
            stream.write_snapshot(**kw)

    ok_all = True
    for seed in range(lo, hi):
        t_seed = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix=f"dccrg_fleet_{seed}_")
        try:
            specs = fleet_specs(seed, n_specs)
            sids = [sp["sid"] for sp in specs]
            specs_path = os.path.join(tmp, "specs.json")
            with open(specs_path, "w") as f:
                json.dump(specs, f)
            env = {
                "DCCRG_GATEWAY_PARK_EVERY": "4",
                "DCCRG_GATEWAY_STALL_S": "120",
                "DCCRG_GATEWAY_QUEUE_MAX": "64",
                "DCCRG_GATEWAY_ADMISSION": "1",
                "DCCRG_SLO_QUEUE_S": "",   # falsy: no ambient budget
            }
            # incarnation 0: one seeded worker kill; the parent SIGKILLs
            # it once the journal shows that kill's redispatch
            wd = os.path.join(tmp, "fleet")
            os.makedirs(wd)
            done_path = os.path.join(wd, "done.json")
            gw_args = [wd, specs_path, n_workers, n_devices]
            p, log = _launch(wd, "fleet-gateway",
                             gw_args + [seed, 1, done_path, device], env,
                             log_name="gateway_0.log")
            journal = os.path.join(wd, "journal.jsonl")
            # the gateway dies once its worker kill is redispatched and a
            # quarter of the scenarios still have half their steps left,
            # so that the relaunched incarnation has work to lose
            need = max(2, len(specs) // 4)
            seen: set = set()
            killed_gw, left = False, None
            t0 = time.monotonic()
            while p.poll() is None and time.monotonic() - t0 < 300.0:
                wm, retired = _journal_progress(journal, seen)
                if "redispatched" in seen:
                    left = sum(1 for sp in specs if sp["sid"] not in retired
                               and 2 * wm.get(sp["sid"], 0) <= int(sp["steps"]))
                    if left >= need:
                        p.kill()
                        p.wait()
                        killed_gw = True
                    break
                time.sleep(0.05)
            log.close()
            record(seed=seed, phase="gateway-sigkill", killed=killed_gw,
                   half_left=left)
            if not killed_gw:
                rc = p.returncode if p.poll() is not None else _wait(p, 60.0)
                why = ("no worker kill redispatched in 300 s" if left is None else
                       f"{left} scenarios had half their steps left at the "
                       f"redispatch, {need} needed")
                print(f"fleet seed {seed}: {why} (gateway rc={rc})\n"
                      f"{_tail(os.path.join(wd, 'gateway_0.log'))}")
                record(seed=seed, outcome="no-progress", exit=rc)
                ok_all = False
                continue
            # incarnation 1 over the same journal: replay, one more kill,
            # drain to completion
            p, log = _launch(wd, "fleet-gateway",
                             gw_args + [seed + 1, 1, done_path, device], env,
                             log_name="gateway_1.log")
            rc = _wait(p, 600.0)
            log.close()
            if rc != 0:
                print(f"fleet seed {seed}: relaunched gateway failed rc={rc}\n"
                      f"{_tail(os.path.join(wd, 'gateway_1.log'), 3000)}")
                for wlog in sorted(glob.glob(os.path.join(wd, "w*", "worker_*.log"))):
                    print(f"--- {os.path.relpath(wlog, wd)}:\n{_tail(wlog, 1500)}")
                record(seed=seed, outcome="relaunch-failed", exit=rc)
                ok_all = False
                continue
            refdir = os.path.join(tmp, "ref")
            try:
                fleet_solo_refs(specs, refdir, n_devices, device)
            except Exception as e:  # noqa: BLE001 — a failed seed, reported
                print(f"fleet seed {seed}: solo oracle failed: {e!r}")
                record(seed=seed, outcome="oracle-failed", error=repr(e)[:200])
                ok_all = False
                continue
            with open(done_path) as f:
                done = json.load(f)

            def ctr(name):
                return sum((done["counters"].get(name) or {}).values())

            fails = []
            if set(done["accepted"]) != set(sids):
                fails.append(f"accepted {done['accepted']} != submitted {sids}")
            if set(done["retired"]) != set(sids):
                fails.append(f"retired {done['retired']} != submitted {sids}")
            if ctr("gateway.journal_replays") < 1:
                fails.append("relaunched gateway never replayed the journal")
            if ctr("gateway.worker_lost") < 1:
                fails.append("incarnation 1's kill counted no gateway.worker_lost")
            if ctr("gateway.redispatched") < 1:
                fails.append("worker loss moved no in-flight work")
            for spec in specs:
                sid = spec["sid"]
                outs = sorted(glob.glob(os.path.join(wd, "w*", f"result_{sid}.npz")))
                if not outs:
                    fails.append(f"{sid}: retired but no worker holds its result")
                    continue
                with np.load(os.path.join(refdir, f"result_{sid}.npz")) as z:
                    want = {k: np.asarray(z[k]) for k in z.files}
                for out in outs:
                    with np.load(out) as z:
                        got = {k: np.asarray(z[k]) for k in z.files}
                    try:
                        if spec["model"] == "gol":
                            np.testing.assert_array_equal(got["alive"], want["alive"])
                        else:
                            for field in ADV_FIELDS:
                                np.testing.assert_allclose(
                                    got[field], want[field], rtol=1e-11, atol=0)
                    except AssertionError as e:
                        fails.append(f"{sid}: {os.path.basename(out)} diverged "
                                     f"from the solo oracle: {str(e)[:200]}")
            dumps = glob.glob(os.path.join(wd, "flightrec_*.json"))
            named = []
            for dump in dumps:
                probs = validate_flightrec(dump)
                if probs:
                    fails.append(f"{os.path.basename(dump)}: {probs[0]}")
                    continue
                with open(dump) as f:
                    rec = json.load(f)
                named += [ev["worker"] for ev in rec.get("events", [])
                          if ev.get("kind") == "worker.lost" and ev.get("worker")]
            if not named:
                fails.append(f"no flight-recorder dump names a lost worker "
                             f"({len(dumps)} dumps)")
            reports, recompiles = [], {}
            for wdir in sorted(glob.glob(os.path.join(wd, "w*"))):
                try:
                    rep = obs_slo.load_report(os.path.join(wdir, "worker.stream.jsonl"))
                except (OSError, ValueError) as e:
                    fails.append(f"{os.path.basename(wdir)}: no final worker stream "
                                 f"({e!r:.120})")
                    continue
                reports.append(rep)
                n = sum(((rep.get("counters") or {}).get("epoch.recompiles")
                         or {}).values())
                recompiles[os.path.basename(wdir)] = n
                if n:
                    fails.append(f"{os.path.basename(wdir)}: replacement not "
                                 f"warm: epoch.recompiles={n}")
            if max(done["generations"].values() or [0]) < 2:
                fails.append(f"no worker was ever replaced ({done['generations']})")
            lat = {}
            for name in ("ensemble.queue_wait_s", "ensemble.e2e_s"):
                series = obs_slo.merge_series(reports, name)
                merged = obs_slo.merge(*series.values()) if series else None
                lat[name] = tuple(obs_slo.quantile(merged, q) if merged else None
                                  for q in (0.5, 0.99))
            p99 = lat["ensemble.e2e_s"][1]
            if p99 is None:
                fails.append("merged worker streams yield no ensemble.e2e_s "
                             "histogram: no fleet p99")
            for msg in fails:
                print(f"fleet seed {seed}: {msg}")
            secs = time.perf_counter() - t_seed
            if report is not None:
                report[seed] = dict(
                    retired=len(done["retired"]), accepted=len(done["accepted"]),
                    kills=done["kills"], generations=done["generations"],
                    redispatches=len(done["redispatches"]), lost_named=sorted(set(named)),
                    recompiles=recompiles, fleet_p99_s=p99, latency_p50_p99_s=lat,
                    seconds=secs,
                    failures=fails)
            record(seed=seed, outcome="ok" if not fails else "failed",
                   retired=len(done["retired"]), kills=done["kills"],
                   generations=done["generations"],
                   redispatches=len(done["redispatches"]), fleet_p99_s=p99,
                   failures=fails)
            if fails:
                ok_all = False
                continue
            print(f"fleet seed {seed}: OK — {len(done['retired'])} retired exactly "
                  f"once across a gateway SIGKILL and {done['kills'] + 1} worker "
                  f"kills; fleet p99={p99!r} s from {len(reports)} merged worker "
                  f"streams; {secs:.1f} s", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    ab_ok, ab = fleet_admission_ab(record, n_devices, device)
    if report is not None:
        report["admission_ab"] = ab
    ok_all = ok_all and ab_ok
    if stream is not None:
        stream.stop(final=True)
    print(f"{'fleet':12s} [{lo},{hi}): {'OK' if ok_all else 'FAIL'}")
    return ok_all


# ---------------------------------------------------------------- CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dccrg_tpu_torch.resilience.soak",
        description="Crash, elastic and fleet soak harnesses of the port.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("crash", "elastic", "fleet"):
        sp = sub.add_parser(name)
        sp.add_argument("--seeds", type=int, nargs=2, default=(0, 5),
                        metavar=("LO", "HI"))
        sp.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
        sp.add_argument("--stream-dir", default=None,
                        help="write per-attempt telemetry JSONL here")
    sp = sub.add_parser("crash-child")
    for a in ("wd", "seed", "nd", "total", "every", "device"):
        sp.add_argument(a)
    sp = sub.add_parser("elastic-child")
    for a in ("wd", "seed", "nd", "total", "every", "do_rescale", "device"):
        sp.add_argument(a)
    sp = sub.add_parser("proof-child")
    for a in ("wd", "nd", "out", "device"):
        sp.add_argument(a)
    sp = sub.add_parser("fleet-gateway")
    for a in ("wd", "specs", "n_workers", "nd", "seed", "n_kills", "done",
              "device"):
        sp.add_argument(a)
    args = ap.parse_args(argv)
    if args.cmd == "fleet":
        return 0 if run_fleet(*args.seeds, stream_dir=args.stream_dir,
                              device=args.device) else 1
    if args.cmd == "fleet-gateway":
        fleet_gateway_child(args.wd, args.specs, int(args.n_workers),
                            int(args.nd), int(args.seed), int(args.n_kills),
                            args.done, args.device)
        return 0
    if args.cmd == "crash":
        return 0 if run_crash(*args.seeds, stream_dir=args.stream_dir,
                              device=args.device) else 1
    if args.cmd == "elastic":
        return 0 if run_elastic(*args.seeds, stream_dir=args.stream_dir,
                                device=args.device) else 1
    if args.cmd == "crash-child":
        crash_child(args.wd, int(args.seed), int(args.nd), int(args.total),
                    int(args.every), args.device)
        return 0
    if args.cmd == "elastic-child":
        from .elastic import DeviceLostError

        try:
            elastic_child(args.wd, int(args.seed), int(args.nd),
                          int(args.total), int(args.every),
                          int(args.do_rescale), args.device)
        except DeviceLostError as e:
            print("DEVICE_LOST:", e, flush=True)
            return 42
        return 0
    proof_child(args.wd, int(args.nd), args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
