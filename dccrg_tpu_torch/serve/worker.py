"""Fleet worker: one supervised process running the ensemble scheduler
loop on its own slots of the card (a port of the JAX package's
``serve/worker.py``: the same scenario seeds and shapes, the same park
format).

The worker is the gateway's unit of failure.  It owns no durable truth
— the gateway's journal does — so its whole protocol is *restatable*:

* **inbox** (``inbox.jsonl``, gateway-appended): assignment records
  carrying the deterministic scenario spec (``model``, ``seed``,
  ``steps``, grid size) plus the resume point (``resume_step`` and the
  ``park`` path of the last watermarked state).  Scenario construction
  is a pure function of the spec (:func:`build_scenario`), so ANY
  worker — the original, a redispatch survivor, or a warm replacement
  — steps the same member to the same bytes.

* **stepping**: every active scenario advances in chunks of
  ``DCCRG_GATEWAY_PARK_EVERY`` interior steps per ensemble round; all
  same-signature chunks batch into one cohort dispatch exactly as the
  single-process server would (``serve/ensemble.py`` is the loop — the
  worker is just its process boundary).  After each chunk the member's
  exact state bytes are parked (atomic tmp+rename ``.npz`` with the
  ``io/checkpoint.py`` directory fsync) and a
  ``watermark`` outbox record names the step and park path: that pair
  is the redispatch resume point.  Chunked stepping is bit-identical
  to uninterrupted stepping because the cohort body is bit-identical
  to solo stepping (the ensemble's oracle) and solo stepping composes.

* **outbox** (``outbox.jsonl``, worker-appended): ``started`` (carries
  the grid's real ``ShapeSignature.label()`` for gateway routing
  affinity), ``watermark``, ``retired`` (result path — the gateway
  dedupes, so a zombie's duplicate retire is harmless), ``handback``
  (drain).

* **heartbeat**: the streaming JSONL (``obs.stream_to``) with the cumulative
  member-step count as the ``step`` progress marker —
  ``HeartbeatMonitor`` distinguishes wedge (daemon ticks, frozen step)
  from silence (SIGKILL) without any exit-code cooperation.

* **drain**: SIGTERM sets a flag; the loop finishes its in-flight
  chunk, parks every active member, appends ``handback`` records and
  exits 0 — the gateway re-routes the parked scenarios to survivors.

Run as ``python -m dccrg_tpu_torch.serve.worker --workdir D --worker-id
W --n-devices N --device cuda|cpu``: the worker's grids live on N slots of
the card (or the CPU).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from .gateway import _JsonlTail, _append_jsonl, _park_every

__all__ = ["build_scenario", "park_state", "resume_state",
           "run_worker", "main"]


def build_scenario(spec: dict, n_devices: int, device: str = "cuda") -> dict:
    """Deterministically construct a scenario bundle from its spec —
    the SAME bytes on every worker and in the solo reference.

    ``spec`` carries ``model`` (``"gol"`` | ``"advection"``), ``seed``,
    optional ``n`` (grid edge).  Returns ``{kind, model, grid, state,
    ids, dt, sig}`` where ``sig`` is the grid's real
    ``ShapeSignature.label()`` (the routing/affinity key); the grid lives
    on ``n_devices`` slots of ``device``."""
    import numpy as np

    from .. import CartesianGeometry, Grid
    from ..models import Advection, GameOfLife

    kind = spec.get("model", "gol")
    seed = int(spec.get("seed", 0))
    rng = np.random.default_rng(seed)
    if kind == "gol":
        n = int(spec.get("n", 10))
        g = (Grid().set_initial_length((n, n, 1))
             .set_neighborhood_length(1)
             .set_periodic(True, True, False)
             .initialize(n_devices=n_devices, device=device))
        g.stop_refining()
        gol = GameOfLife(g)
        cells = g.get_cells()
        state = gol.new_state(
            alive_cells=cells[rng.random(len(cells)) < 0.35])
        return {"kind": "gol", "model": gol, "grid": g, "state": state,
                "ids": cells, "dt": None,
                "sig": g.shape_signature().label()}
    if kind == "advection":
        n = int(spec.get("n", 4))
        g = (Grid().set_initial_length((n, n, n))
             .set_neighborhood_length(0)
             .set_periodic(True, True, True)
             .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / n,) * 3)
             .initialize(n_devices=n_devices, device=device))
        g.stop_refining()
        ids = g.get_cells()
        adv = Advection(g)
        s = adv.initialize_state()
        s = adv.set_cell_data(s, "density", ids,
                              rng.uniform(1, 2, len(ids)))
        for f in ("vx", "vy", "vz"):
            s = adv.set_cell_data(s, f, ids,
                                  rng.uniform(-0.2, 0.2, len(ids)))
        if adv.dense is None:
            # a row state: the ghosts take the new values (a dense
            # state's slab ring is read by every step)
            s = g.update_copies_of_remote_neighbors(s)
        dt = 0.3 * float(adv.max_time_step(s))
        return {"kind": "advection", "model": adv, "grid": g,
                "state": s, "ids": ids, "dt": dt,
                "sig": g.shape_signature().label()}
    raise ValueError(f"unknown scenario model {kind!r}")


def park_state(bundle: dict, state, path: str, step: int = 0) -> None:
    """Park one member's exact state bytes: tmp + fsync + rename (the
    ``io/checkpoint.py`` torn-write discipline) so a kill mid-park
    leaves the previous park intact.  The step count is stored INSIDE
    the park, making it self-describing: a kill between the park
    rename and the watermark outbox append leaves a park newer than
    the journal, and the resumer must trust the park's own step, not
    the journaled one, or it would re-step a segment the parked state
    already contains."""
    import numpy as np

    from ..io.checkpoint import _fsync_dir

    if bundle["kind"] == "gol":
        arrs = {"alive": np.sort(np.asarray(
            bundle["model"].alive_cells(state)))}
    else:
        # the MODEL's accessor, not the grid's: advection picks a dense
        # (D, z, y, x) layout for regular meshes, and only the model
        # knows which layout this state is in
        m, ids = bundle["model"], bundle["ids"]
        arrs = {f: np.asarray(m.get_cell_data(state, f, ids), np.float64)
                for f in ("density", "vx", "vy", "vz")}
    arrs["step"] = np.asarray(int(step), np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def resume_state(bundle: dict, path: str):
    """Rebuild ``(state, step)`` from a park — the set-cell-data path
    mirrors fresh construction, so resumed bytes equal parked bytes,
    and the park's own step count is authoritative (see
    :func:`park_state`)."""
    import numpy as np

    with np.load(path) as z:
        step = int(z["step"]) if "step" in z else 0
        if bundle["kind"] == "gol":
            return bundle["model"].new_state(
                alive_cells=np.asarray(z["alive"])), step
        g, adv, ids = bundle["grid"], bundle["model"], bundle["ids"]
        s = adv.initialize_state()
        for f in ("density", "vx", "vy", "vz"):
            s = adv.set_cell_data(s, f, ids, np.asarray(z[f]))
        if adv.dense is not None:
            return s, step
        return g.update_copies_of_remote_neighbors(s), step


def run_worker(workdir: str, wid: str, n_devices: int,
               max_idle_s: float | None = None, device: str = "cuda") -> int:
    """The worker loop: inbox → chunked ensemble stepping → parks,
    watermarks, retirements → heartbeat.  Runs until SIGTERM (drain)
    or — when ``max_idle_s`` is set — after that long with nothing
    assigned (the probe/test mode; production workers wait forever)."""
    from .. import obs
    from ..obs.flightrec import recorder as flightrec
    from .ensemble import Ensemble

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    inbox = _JsonlTail(os.path.join(workdir, "inbox.jsonl"))
    outbox = os.path.join(workdir, "outbox.jsonl")
    hb = obs.stream_to(os.path.join(workdir, "worker.stream.jsonl"),
                       period=0.5, truncate=True,
                       extra={"worker": wid, "n_devices": n_devices})
    # black box: a SIGKILLed worker leaves a schema-valid postmortem
    # naming the member chunks it had in flight
    flightrec.arm(workdir, period=1.0)

    draining = {"flag": False}

    def _on_term(signum, frame):
        draining["flag"] = True

    signal.signal(signal.SIGTERM, _on_term)

    ens = Ensemble()
    chunk = _park_every()
    active: dict = {}       # sid -> {spec, bundle, state, done, steps}
    total_done = 0
    idle_since = time.monotonic()
    while True:
        if not draining["flag"]:
            for rec in inbox.poll():
                sid = str(rec.get("sid"))
                if sid in active:
                    continue    # duplicate assignment (at-least-once)
                try:
                    bundle = build_scenario(rec, n_devices, device)
                except (ValueError, KeyError) as e:
                    _append_jsonl(outbox, {"ev": "retired", "sid": sid,
                                           "step": 0, "result": None,
                                           "error": repr(e)})
                    continue
                state, done = bundle["state"], 0
                park = rec.get("park")
                if park and os.path.exists(park):
                    state, done = resume_state(bundle, park)
                _append_jsonl(outbox, {"ev": "started", "sid": sid,
                                       "sig": bundle["sig"],
                                       "step": done})
                active[sid] = {"spec": rec, "bundle": bundle,
                               "state": state, "done": done,
                               "steps": int(rec.get("steps", 1))}
        runnable = {sid: a for sid, a in active.items()
                    if a["done"] < a["steps"]}
        if runnable:
            idle_since = time.monotonic()
            t0 = time.perf_counter()
            tickets = {}
            for sid, a in runnable.items():
                k = min(chunk, a["steps"] - a["done"])
                flightrec.mark_unit(f"{sid}/{a['done']}", sid=sid,
                                    step=a["done"], k=k, worker=wid)
                tickets[sid] = (ens.submit(
                    a["bundle"]["model"], a["state"], steps=k,
                    dt=a["bundle"]["dt"],
                    tenant=a["spec"].get("tenant", "default")), k)
            ens.run()
            busy = (time.perf_counter() - t0) / max(1, len(tickets))
            for sid, (t, k) in tickets.items():
                a = active[sid]
                a["state"] = t.result
                a["done"] += k
                total_done += k
                if a["done"] >= a["steps"]:
                    res = os.path.join(workdir, f"result_{sid}.npz")
                    park_state(a["bundle"], a["state"], res, a["done"])
                    _append_jsonl(outbox, {"ev": "retired", "sid": sid,
                                           "step": a["done"],
                                           "result": res,
                                           "busy_s": busy})
                    del active[sid]
                else:
                    park = os.path.join(workdir, f"park_{sid}.npz")
                    park_state(a["bundle"], a["state"], park, a["done"])
                    _append_jsonl(outbox, {"ev": "watermark",
                                           "sid": sid,
                                           "step": a["done"],
                                           "park": park,
                                           "busy_s": busy})
        # the step marker: HeartbeatMonitor's progress signal — a wedge
        # inside ens.run() leaves only frozen daemon ticks behind
        hb.write_snapshot(step=total_done, active=len(active),
                          draining=bool(draining["flag"]))
        if draining["flag"]:
            for sid, a in list(active.items()):
                park = os.path.join(workdir, f"park_{sid}.npz")
                park_state(a["bundle"], a["state"], park, a["done"])
                _append_jsonl(outbox, {"ev": "handback", "sid": sid,
                                       "step": a["done"], "park": park})
            hb.write_snapshot(step=total_done, active=0, draining=True)
            return 0
        if not runnable:
            if (max_idle_s is not None
                    and time.monotonic() - idle_since > max_idle_s):
                return 0
            time.sleep(0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dccrg fleet worker (spawned by serve/gateway.py)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--max-idle-s", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    return run_worker(a.workdir, a.worker_id, a.n_devices,
                      max_idle_s=a.max_idle_s, device=a.device)


if __name__ == "__main__":
    sys.exit(main())
