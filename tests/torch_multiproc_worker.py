"""One controller of the port's multi-controller tests
(``tests/test_torch_multiprocess.py``).

Run as ``python tests/torch_multiproc_worker.py D [workdir [mode]]`` by
``dccrg_tpu_torch.parallel.mesh.launch`` (the controllers' environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), it joins the
gloo group on the CPU and prints one ``RESULT {json}`` line.  Mode
``scenarios`` (the default) runs the JAX package's multi-controller
scenarios 1-5, 7 and 9 (``tests/multiproc_worker.py``) on a grid of D
slots, the gather advection with per-controller adaptation requests and
balance, per-controller unrefines of one sibling family (C2) and the
staged migration of unsigned fields (C3); ``dense`` runs the dense slab
ring's cases (:func:`dense_scenarios`, ``tests/test_torch_dense_ring.py``);
``models`` Poisson, particles and the refined advection run's flat and boxed
forms (:func:`model_scenarios`, ``tests/test_torch_models_spmd.py``);
``ring`` the ring's planes alone; ``ipc`` the device-direct transport's
cases (:func:`ipc_scenarios`, ``tests/test_torch_transport_ipc.py``).
The transport is ``DCCRG_TORCH_DIST_BACKEND`` (gloo by default; ``launch``
sets it).  Each function with the single
controller is the one-controller oracle: it applies every rank's requests
itself, in rank order.
"""
import contextlib
import hashlib
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hash(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _ranks(ctl, nproc):
    """The ranks whose per-controller requests this process applies: its
    own under several controllers, all of them (in rank order) alone."""
    return [ctl.rank] if ctl.multi else list(range(nproc))


def scenarios(ctl, nproc: int, D: int, workdir: str) -> dict:
    from dccrg_tpu_torch import Advection, GameOfLife, Grid, obs
    from dccrg_tpu_torch.utils.collectives import (all_reduce, barrier, fetch,
                                                    some_reduce)
    from dccrg_tpu_torch.utils.verify import verify_grid, verify_user_data

    def grid(length, max_ref=0, lb="RCB"):
        return (Grid().set_initial_length(length)
                .set_maximum_refinement_level(max_ref)
                .set_neighborhood_length(1).set_load_balancing_method(lb)
                .initialize(n_devices=D, device="cpu", controllers=ctl))

    res = {"nproc": nproc, "n_devices": D}

    # ---- 1: Game of Life across the controller boundary (blinker)
    g = grid((10, 10, 1))
    gol = GameOfLife(g, allow_dense=False)
    s = gol.new_state(alive_cells=[54, 55, 56])
    blinker = []
    for _ in range(4):
        s = gol.step(s)
        blinker.append(sorted(int(c) for c in gol.alive_cells(s)))
    res["blinker"] = blinker

    # ---- 2: AMR with per-controller requests (controller p refines 3 + p)
    g2 = grid((4, 4, 2), max_ref=2)
    spec = {"rho": ((), np.float64)}
    st2 = g2.new_state(spec)
    cells = g2.get_cells()
    st2 = g2.set_cell_data(st2, "rho", cells, np.arange(1.0, len(cells) + 1))
    mass0 = float(fetch(st2["rho"]).sum())
    for p in _ranks(ctl, nproc):
        assert g2.refine_completely(3 + p)
    g2.stop_refining()
    st2 = g2.remap_state(st2, policy={"rho": {"refine": "inherit"}})
    verify_grid(g2)
    ids = np.sort(g2.leaves.cells)
    res["amr"] = {"n_leaves": int(len(ids)), "ids_hash": _hash(ids),
                  "mass0": mass0,
                  "mass1": float((fetch(st2["rho"]) * g2.epoch.local_mask).sum())}

    # ---- 3: ghost bit-identity over the transport, three fields
    rng = np.random.default_rng(7)
    spec3 = {"a": ((), np.float64), "b": ((3,), np.float32),
             "c": ((), np.uint32)}
    c2 = g2.get_cells()
    st3 = g2.state_from_host(spec3, c2, {
        "a": rng.random(len(c2)),
        "b": rng.random((len(c2), 3)).astype(np.float32),
        "c": rng.integers(0, 2**32, len(c2), dtype=np.uint64).astype(np.uint32)})
    verify_user_data(g2, st3, spec3)
    ex = g2.halo()
    ghosts = {n: _hash(fetch(v)) for n, v in ex(st3).items()}
    handle = ex.start(st3)
    split = {n: _hash(fetch(v)) for n, v in ex.finish(st3, handle).items()}
    assert split == ghosts
    # B9's twin (the pallas backend on CPU tensors) under the verify
    # oracle: the plain twin over the same transport
    from dccrg_tpu_torch.parallel.halo import HaloExchange

    env = {"DCCRG_HALO_BACKEND": "pallas", "DCCRG_HALO_VERIFY": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        exv = HaloExchange(g2.epoch, g2.epoch.hoods[None], g2.device,
                           controllers=g2.controllers)
        assert exv.backend == "pallas"
        verified = {n: _hash(fetch(v)) for n, v in exv(st3).items()}
        exv.finish(st3, exv.start(st3))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert verified == ghosts
    assert exv.verify_checks == 2 * len(spec3) and not exv.verify_mismatches
    # a per-cell payload policy: each field its own filtered schedule
    policy = lambda field, ids, sender, receiver, hood: (ids + len(field)) % 3 != 0
    filtered = {n: _hash(fetch(v)) for n, v in g2.halo(cell_datatype=policy)(st3).items()}
    res["ghost"] = {"verify": "ok", "hashes": ghosts, "policy": filtered,
                    "oracle_checks": exv.verify_checks}

    # ---- 3b: per-slot halo telemetry: each controller counts its own
    # slots; the sums over controllers are the schedule's pair counts
    st_rho = g2.state_from_host(spec, c2, {"rho": rng.random(len(c2))})

    def counters(name):
        return np.asarray([int(obs.metrics.counter_value(name, device=d, hood="default"))
                           for d in range(D)], np.int64)

    send0, recv0 = counters("halo.send_cells"), counters("halo.recv_cells")
    bytes0 = int(obs.metrics.counter_value("halo.bytes_moved"))
    g2.update_copies_of_remote_neighbors(st_rho)
    dsend = all_reduce([counters("halo.send_cells") - send0])
    drecv = all_reduce([counters("halo.recv_cells") - recv0])
    dbytes = int(all_reduce([int(obs.metrics.counter_value("halo.bytes_moved")) - bytes0]))
    pc = g2.epoch.hoods[None].pair_counts
    assert dsend.tolist() == pc.sum(axis=1).tolist(), dsend
    assert drecv.tolist() == pc.sum(axis=0).tolist(), drecv
    assert dbytes == int(dsend.sum()) * 8
    res["telemetry"] = {"halo_send_cells": dsend.tolist(),
                        "halo_recv_cells": drecv.tolist(),
                        "halo_bytes_moved": dbytes}

    # ---- 4: balance_load with per-controller pins (rank order merge)
    first, last = int(ids[0]), int(ids[-1])
    for p in _ranks(ctl, nproc):
        if p == 0:
            assert g2.pin(first, D - 1)
        else:
            assert g2.pin(last, 0)
    g2.balance_load()
    st2 = g2.remap_state(st2)
    verify_grid(g2)
    owners = g2.leaves.owner
    res["pins"] = {
        "owners_hash": _hash(np.asarray(owners, dtype=np.int64)),
        "first_owner": int(owners[int(g2.leaves.position(np.uint64(first)))]),
        "last_owner": int(owners[int(g2.leaves.position(np.uint64(last)))]),
        "mass2": float((fetch(st2["rho"]) * g2.epoch.local_mask).sum()),
    }

    # ---- 5: checkpoint fan-in and reload across controllers
    ckpt = os.path.join(workdir, f"ckpt_{nproc}_{int(ctl.multi)}.dc")
    g2.save_grid_data(st2, ckpt, spec, user_header=b"mp-test")
    g3, st3b, hdr = Grid.load_grid_data(ckpt, spec, n_devices=D, device="cpu")
    assert hdr == b"mp-test"
    assert np.array_equal(np.sort(g3.leaves.cells), ids)
    live = g2.get_cell_data(st2, "rho", ids)
    reloaded = g3.get_cell_data(st3b, "rho", ids)
    assert np.array_equal(live, reloaded), "checkpoint round trip differs"
    with open(ckpt, "rb") as f:
        file_hash = _hash(np.frombuffer(f.read(), np.uint8))
    res["ckpt"] = {"rho_hash": _hash(reloaded), "file_hash": file_hash}
    barrier("ckpt_asserts_done")

    # ---- advection's gather step: steps, per-controller adaptation,
    # pinned HSFC balance (one-shot and staged), steps
    ga = (Grid().set_initial_length((6, 6, 6)).set_maximum_refinement_level(1)
          .set_neighborhood_length(0).set_periodic(True, True, True)
          .set_load_balancing_method("HSFC")
          .set_geometry(start=(0.0, 0.0, 0.0), level_0_cell_length=(1 / 6,) * 3)
          .initialize(n_devices=D, device="cpu", controllers=ctl))
    adv = Advection(ga, allow_dense=False, use_kernels=False)
    sa = adv.initialize_state()
    dt = 0.5 * adv.max_time_step(sa)
    for _ in range(3):
        sa = adv.step(sa, dt)
    for p in _ranks(ctl, nproc):
        ga.refine_completely_many(ga.get_cells()[[5 * p, 40 + 7 * p, 100 + p]])
    adv, sa, new_cells, _ = adv.adapt_grid(sa)
    for p in _ranks(ctl, nproc):
        ga.pin(int(ga.get_cells()[p]), D - 1 - p)
    ga.set_cell_weight(int(new_cells[0]), 3.0)
    ga.initialize_balance_load()
    while ga.continue_balance_load(sa, max_cells=60):
        pass
    staged = ga.finish_balance_load(sa)
    sa = ga.update_copies_of_remote_neighbors(ga.remap_state(sa))
    cells_a = ga.get_cells()
    for name in adv.spec:
        assert np.array_equal(ga.get_cell_data(staged, name, cells_a),
                              ga.get_cell_data(sa, name, cells_a)), name
    adv = Advection(ga, allow_dense=False, use_kernels=False)
    for _ in range(3):
        sa = adv.step(sa, dt)
    rho = ga.get_cell_data(sa, "density", cells_a)
    res["advection"] = {"n_leaves": int(len(cells_a)),
                        "owners_hash": _hash(ga.leaves.owner.astype(np.int64)),
                        "rho_hash": _hash(rho), "mass": adv.total_mass(sa),
                        "max_dt": adv.max_time_step(sa)}

    # ---- C2 and C3: per-controller unrefines of one family, and the
    # staged migration of unsigned fields
    res["unrefine_families"] = unrefine_families(ctl, nproc, D)[0]
    res["staged_unsigned"] = staged_unsigned(ctl, D)[0]

    # ---- 7: point-to-point Some_Reduce
    counts = np.asarray([g.get_local_cell_count(d) for d in range(D)], np.uint64)
    res["some_reduce"] = {"device0": int(some_reduce(g, counts, 0))}
    if ctl.multi:
        res["some_reduce"]["clique"] = _p2p(ctl, nproc)

    # ---- 9: enforced agreement for host mutators
    if ctl.multi:
        res["agreement"] = _agreement(ctl, g, D)
    return res


def _grid(ctl, D, length, max_ref=0, hood=1, lb="RCB", periodic=(False,) * 3,
          cell=None):
    from dccrg_tpu_torch import CartesianGeometry, Grid

    g = (Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(hood).set_load_balancing_method(lb)
         .set_periodic(*periodic))
    if cell is not None:
        g = g.set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=cell)
    return g.initialize(n_devices=D, device="cpu", controllers=ctl)


#: C2's families: the cells refined first, and the child (by position in
#: ``get_all_children``) each controller queues for unrefinement: the
#: first family a different child a rank, the second the same child on
#: every rank
C2_FAMILIES = ((6, lambda p: (3 * p) % 8), (11, lambda p: 2))


def unrefine_families(ctl, nproc, D):
    """C2: on a 4x4x2 grid with cells 6 and 11 refined, every controller
    queues the unrefine of a child of each (different children of 6, the
    same child of 11); the one-controller oracle applies every rank's
    requests in rank order, so it queues one child a family.  Returns
    (hashes of the leaves, owners and the "mean" / "sum" remapped fields by
    cell id, the arrays)."""
    from dccrg_tpu_torch.utils.verify import verify_grid

    g = _grid(ctl, D, (4, 4, 2), max_ref=1)
    for cell, _ in C2_FAMILIES:
        assert g.refine_completely(cell)
    g.stop_refining()
    cells = g.get_cells()
    vals = {"rho": np.sin(cells.astype(np.float64)),
            "q": np.cos(3.0 * cells.astype(np.float64))}
    st = g.state_from_host({"rho": ((), np.float64), "q": ((), np.float64)},
                           cells, vals)
    for cell, child in C2_FAMILIES:
        kids = g.mapping.get_all_children(np.asarray([cell], np.uint64))[0]
        for p in _ranks(ctl, nproc):
            assert g.unrefine_completely(int(kids[child(p)]))
    g.stop_refining()
    st = g.remap_state(st, policy={"rho": {"unrefine": "mean"},
                                   "q": {"unrefine": "sum"}})
    verify_grid(g)
    ids = g.get_cells()
    out = {"ids": ids, "owner": g.leaves.owner.astype(np.int64),
           "rho": g.get_cell_data(st, "rho", ids), "q": g.get_cell_data(st, "q", ids)}
    return {k: _hash(v) for k, v in out.items()} | {"n_leaves": int(len(ids))}, out


#: C3's unsigned fields, filled with every bit (uint64 past 2**63)
C3_FIELDS = {"u16": np.uint16, "u32": np.uint32, "u64": np.uint64}


def staged_unsigned(ctl, D, chunk=20):
    """C3: a 12x12 Game of Life board at 30% alive, cells 1-29 weighted 4,
    migrated by the staged balance in chunks of ``chunk`` cells together
    with uint16 / uint32 / uint64 fields; two turns after it.  Returns
    (hashes of the owners, every field by cell id and the alive set after
    the turns, the arrays)."""
    from dccrg_tpu_torch import GameOfLife

    g = _grid(ctl, D, (12, 12, 1))
    cells = g.get_cells()
    rng = np.random.default_rng(3)
    gol = GameOfLife(g, allow_dense=False)
    s = gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
    extra = {k: rng.integers(0, np.iinfo(t).max, len(cells), dtype=t, endpoint=True)
             for k, t in C3_FIELDS.items()}
    s = {**s, **g.state_from_host({k: ((), t) for k, t in C3_FIELDS.items()},
                                  cells, extra)}
    for c in range(1, 30):
        g.set_cell_weight(c, 4.0)
    g.initialize_balance_load()
    while g.continue_balance_load(s, max_cells=chunk):
        pass
    s = g.finish_balance_load(s)
    out = {"owner": g.leaves.owner.astype(np.int64)}
    for k in s:
        out[k] = g.get_cell_data(s, k, cells)
    gol = GameOfLife(g, allow_dense=False)
    s = gol.run(g.update_copies_of_remote_neighbors(s), 2)
    out["alive"] = np.sort(gol.alive_cells(s))
    return {k: _hash(v) for k, v in out.items()}, out


# ------------------------------------------------ the dense slab ring (D1, D3)

def ring_check(ctl, D, per_slot=3):
    """The controller ring's planes of a ``[D, per_slot, 2, 5]`` stack of
    distinct values (this controller's slots) against one controller's
    roll of the whole stack, for float32 and int64; returns the planes'
    hash (every slot, a collective)."""
    import torch

    from dccrg_tpu_torch.parallel.dense import HaloExtend
    from dccrg_tpu_torch.utils.collectives import fetch

    slots = ctl.local_slots(D)
    out = []
    for dtype in (torch.float32, torch.int64):
        full = torch.arange(D * per_slot * 10, dtype=dtype).reshape(D, per_slot, 2, 5)
        ring = HaloExtend(D, ctl)
        below, above = ring.planes(full[slots.start:slots.stop].clone())
        want_lo = torch.roll(full[:, -1:], 1, 0)[slots.start:slots.stop]
        want_hi = torch.roll(full[:, :1], -1, 0)[slots.start:slots.stop]
        assert torch.equal(below, want_lo) and torch.equal(above, want_hi), (
            f"ring planes differ on slots {list(slots)}")
        sent = 2 * 10 * full.element_size() if ctl.multi else 0
        assert ring.transport_bytes == sent, (ring.transport_bytes, sent)
        out += [fetch(below), fetch(above)]
    return _hash(np.concatenate([a.reshape(-1).view(np.uint8) for a in out]))


#: dense advection's forms: nz (by the slot count D), dtype, ``dense_kind``
#: by D ("blocked" takes kernel B2, "plane" B3, "plain" the torch step)
ADV_FORMS = {
    "blocked": (lambda D: 48, np.float32, {8: ("blocked_direct", 2),
                                           6: ("blocked_direct", 8)}),
    "plane": (lambda D: 3 * D, np.float32, {8: ("plane",), 6: ("plane",)}),
    "plain": (lambda D: 48, np.float64, {8: ("xla",), 6: ("xla",)}),
}


def adv_setup(ctl, D, form, periodic_z):
    """A dense advection model on a 6x5xnz grid of D slots, its initial
    state with a vz that crosses every z face (all six faces carry flux,
    the open z ends too) and a dt."""
    from dccrg_tpu_torch import Advection

    nz_of, dtype, _ = ADV_FORMS[form]
    nz = nz_of(D)
    g = _grid(ctl, D, (6, 5, nz), hood=0, periodic=(True, True, periodic_z),
              cell=(1 / 6, 1 / 5, 1 / nz))
    adv = Advection(g, dtype=dtype)
    s = adv.initialize_state()
    cells = g.get_cells()
    vz = 0.15 + 0.3 * np.sin(2 * np.pi * g.geometry.get_center(cells)[:, 2])
    s = adv.set_cell_data(s, "vz", cells, vz)
    return adv, s, 0.4 * adv.max_time_step(s)


def adv_case(ctl, D, form, periodic_z, steps=6):
    """Two steps, a run of ``steps``, the refinement indicator, the mass and
    the CFL limit of :func:`adv_setup`'s model; the run's ring bytes."""
    from dccrg_tpu_torch.convert import state_to_numpy

    adv, s, dt = adv_setup(ctl, D, form, periodic_z)
    assert adv.dense is not None and not adv.fused
    out = {"kind": list(adv.dense_kind)}
    for i in range(2):
        s = adv.step(s, dt)
        out[f"step{i}"] = _hash(state_to_numpy(s)["density"])
    b0 = adv._extend.transport_bytes
    s = adv.run(s, steps, dt)
    out["run_bytes"] = adv._extend.transport_bytes - b0
    out["run"] = _hash(state_to_numpy(s)["density"])
    md = adv.compute_max_diff(s, 0.25)["max_diff"]
    out["max_diff"] = _hash(state_to_numpy({"m": md})["m"])
    out["mass"] = adv.total_mass(s)
    out["max_dt"] = adv.max_time_step(s)
    ids = adv.grid.get_cells()[::7]
    out["by_id"] = _hash(adv.get_cell_data(s, "density", ids))
    return out


def board_setup(ctl, D, periodic_y):
    """The dense 2-D board: 10x24 (24 rows divide over 8 and 6 slots) at
    30% alive."""
    from dccrg_tpu_torch import GameOfLife

    g = _grid(ctl, D, (10, 24, 1), periodic=(False, periodic_y, False))
    gol = GameOfLife(g)
    cells = g.get_cells()
    alive = cells[np.random.default_rng(5).random(len(cells)) < 0.3]
    return gol, gol.new_state(alive_cells=alive)


def board_case(ctl, D, periodic_y, turns=12):
    gol, s = board_setup(ctl, D, periodic_y)
    assert gol.dense2d is not None and not gol.fused
    b0 = gol._ring.transport_bytes
    s = gol.run(s, turns)
    return {"alive": _hash(np.sort(gol.alive_cells(s))),
            "run_bytes": gol._ring.transport_bytes - b0}


def vlasov_setup(ctl, D, dtype, periodic_z, refine=False):
    """Vlasov with nv = 2 on a dense 4x4x48 slab grid of D slots, or (with
    ``refine``) the row layout on an 8^3 grid with a ball refined; its
    initial state and a dt."""
    from dccrg_tpu_torch import Vlasov

    if refine:
        g = _grid(ctl, D, (8, 8, 8), max_ref=1, hood=0,
                  periodic=(True, True, periodic_z), cell=(1 / 8,) * 3)
        ids = g.get_cells()
        g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5,
                                                    axis=1) < 0.3])
        g.stop_refining()
    else:
        g = _grid(ctl, D, (4, 4, 48), hood=0, periodic=(True, True, periodic_z),
                  cell=(1 / 4, 1 / 4, 1 / 48))
    vl = Vlasov(g, nv=2, dtype=dtype)
    s = vl.initialize_state()
    return vl, s, vl._scalar(0.4 * vl.max_time_step())


def vlasov_case(ctl, D, dtype, periodic_z, refine=False, steps=4):
    from dccrg_tpu_torch.convert import state_to_numpy

    vl, s, dt = vlasov_setup(ctl, D, dtype, periodic_z, refine)
    out = {"fused_block": vl._fused_block, "dense": vl.info is not None}
    b0 = vl._extend.transport_bytes if vl.info is not None else 0
    s1 = vl.step(s, dt)
    s = vl.run(s1, steps, dt)
    if vl.info is not None:
        out["run_bytes"] = vl._extend.transport_bytes - b0
        out["step"] = _hash(state_to_numpy(s1)["f"])
        out["run"] = _hash(state_to_numpy(s)["f"])
    else:
        ids = vl.grid.get_cells()
        out["step"] = _hash(vl.grid.get_cell_data(s1, "f", ids))
        out["run"] = _hash(vl.grid.get_cell_data(s, "f", ids))
    out["mass"] = vl.total_mass(s)
    out["density"] = _hash(vl.density(s))
    return out


def adapt_setup(ctl, D):
    """Dense f64 advection on a periodic 6x6x24 grid that may refine once."""
    from dccrg_tpu_torch import Advection

    g = _grid(ctl, D, (6, 6, 24), max_ref=1, hood=0, periodic=(True,) * 3,
              cell=(1 / 6, 1 / 6, 1 / 24))
    adv = Advection(g)
    s = adv.initialize_state()
    return adv, s, 0.4 * adv.max_time_step(s)


def adapt_case(ctl, D):
    """Steps on the dense layout, ``check_for_adaptation`` and
    ``adapt_grid`` (the hand-off to the row layout), steps after it."""
    adv, s, dt = adapt_setup(ctl, D)
    assert adv.dense is not None
    for _ in range(3):
        s = adv.step(s, dt)
    s = adv.check_for_adaptation(s)
    adv, s, new_cells, removed = adv.adapt_grid(s)
    assert adv.dense is None and len(new_cells)
    for _ in range(3):
        s = adv.step(s, dt)
    g = adv.grid
    ids = g.get_cells()
    return {"ids": _hash(ids), "owner": _hash(g.leaves.owner.astype(np.int64)),
            "new_cells": int(len(new_cells)),
            "rho": _hash(g.get_cell_data(s, "density", ids)),
            "mass": adv.total_mass(s)}


#: the dense cases of :func:`dense_scenarios`, by name
DENSE_CASES = {
    "adv_blocked_periodic": lambda c, D: adv_case(c, D, "blocked", True),
    "adv_blocked_open": lambda c, D: adv_case(c, D, "blocked", False),
    "adv_plane_periodic": lambda c, D: adv_case(c, D, "plane", True),
    "adv_plane_open": lambda c, D: adv_case(c, D, "plane", False),
    "adv_plain_periodic": lambda c, D: adv_case(c, D, "plain", True),
    "adv_plain_open": lambda c, D: adv_case(c, D, "plain", False),
    "board_open": lambda c, D: board_case(c, D, False),
    "board_periodic": lambda c, D: board_case(c, D, True),
    "vlasov_f32_open": lambda c, D: vlasov_case(c, D, np.float32, False),
    "vlasov_f64_periodic": lambda c, D: vlasov_case(c, D, np.float64, True),
    "vlasov_gather": lambda c, D: vlasov_case(c, D, np.float64, False, refine=True),
    "adapt_from_dense": adapt_case,
}


def dense_scenarios(ctl, nproc: int, D: int) -> dict:
    """Every dense case on D slots (the one-controller oracle runs them on
    the same slots alone), and the ring's planes."""
    res = {"nproc": nproc, "n_devices": D, "ring": ring_check(ctl, D)}
    for name, case in DENSE_CASES.items():
        res[name] = case(ctl, D)
    return res


# ------------------- Poisson (D4), particles (D5), the flat and boxed forms (D2)

def _slabs_hash(ctl, D, vox, nzl):
    """Hash of a flat voxel block ``[len(slots) * nzl, ny, nx]`` as every
    slot's ``[D, nzl, ny, nx]`` (a collective)."""
    from dccrg_tpu_torch.utils.collectives import fetch

    return _hash(fetch(vox.reshape(len(ctl.local_slots(D)), nzl, *vox.shape[1:])))


def poisson_s6(ctl, D):
    """The JAX worker's scenario 6: the flat voxel BiCG on an n = D periodic
    uniform grid, hood 0, f64, 25 iterations with no early stop.  Returns
    the model, the solve's output state, residual and iterations."""
    from dccrg_tpu_torch import Poisson

    g = _grid(ctl, D, (D, D, D), hood=0, periodic=(True,) * 3,
              cell=(1.0 / D,) * 3)
    cells = g.get_cells()
    cen = g.geometry.get_center(cells)
    p = Poisson(g)
    s = p.initialize_state(np.sin(2 * np.pi * cen[:, 0]) * np.cos(2 * np.pi * cen[:, 1]))
    out, res, it = p.solve(s, max_iterations=25, stop_residual=0.0,
                           stop_after_residual_increase=float("inf"))
    return p, out, res, it


def refined_poisson_grid(ctl, D, periodic_z=True, levels=1):
    """A 4x4x24 grid (24 level-0 planes divide over 8 and 6 slots) with a
    ball refined ``levels`` times, ``BLOCK``: the voxel z-slab ownership
    the flat operator takes."""
    g = _grid(ctl, D, (4, 4, 24), max_ref=levels, hood=0, lb="BLOCK",
              periodic=(True, True, periodic_z), cell=(0.25, 0.25, 1 / 24))
    for rad in (0.2, 0.1)[:levels]:
        ids = g.get_cells()
        lv = g.mapping.get_refinement_level(ids)
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
        g.stop_refining()
    return g


def _rhs(g):
    c = g.geometry.get_center(g.get_cells())
    return np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1]) * (1.0 + c[:, 2])


def poisson_solve(ctl, D, space, periodic_z=True, iterations=30):
    """Poisson in operator space ``space`` on :func:`refined_poisson_grid`,
    f64, a seeded rhs: the model and its solve of ``iterations``, no early
    stop."""
    from dccrg_tpu_torch import Poisson

    g = refined_poisson_grid(ctl, D, periodic_z)
    p = Poisson(g, allow_flat=space == "flat", allow_rolled=space == "rolled")
    assert p.operator_space == space, (p.operator_space, space)
    s = p.initialize_state(_rhs(g))
    out, res, it = p.solve(s, max_iterations=iterations, stop_residual=0.0,
                           stop_after_residual_increase=float("inf"))
    return p, out, res, it


def poisson_case(ctl, D, fn):
    p, out, res, it = fn(ctl, D)
    g = p.grid
    sol = g.get_cell_data(out, "solution", g.get_cells())
    rec = {"space": p.operator_space, "iterations": int(it), "residual": float(res),
           "solution": _hash(sol), "gather_residual": p.residual(out)}
    if p.operator_space == "flat":
        rec["n_devices"] = int(p._flat_tables["n_devices"])
    return rec


def flat_apply_case(ctl, D, periodic_z, levels=1):
    """The flat operator's A·v and Aᵀ·v of a seeded row vector on a refined
    grid: the voxel results, every slot's slab."""
    import torch

    from dccrg_tpu_torch import Poisson

    g = refined_poisson_grid(ctl, D, periodic_z, levels)
    p = Poisson(g)
    assert p.operator_space == "flat"
    fwd, rev, voxelize, writeback, _ = p._flat
    cells = g.get_cells()
    x = g.state_from_host({"x": ((), np.float64)}, cells, {
        "x": np.random.default_rng(3).standard_normal(len(cells))})["x"]
    v = voxelize(x)
    nzl = p._flat_tables["shape"][0] // D
    out = {"fwd": _slabs_hash(ctl, D, fwd(v), nzl),
           "rev": _slabs_hash(ctl, D, rev(v), nzl),
           "rows": _hash(g.get_cell_data({"y": writeback(fwd(v))}, "y", cells))}
    assert torch.isfinite(v).all()
    return out


def particles_s8(ctl, D, dtype=np.float64):
    """The JAX worker's scenario 8: 4x4xD, hood 1, the first cell refined,
    120 particles from ``default_rng(42)``, ``run(5)`` at (0.03, 0.02,
    0.11), dt 0.5, in ``dtype`` (float64: the JAX comparison's)."""
    from dccrg_tpu_torch import Particles

    g = _grid(ctl, D, (4, 4, D), max_ref=1, hood=1, periodic=(True,) * 3,
              cell=(0.25, 0.25, 1.0 / D))
    assert g.refine_completely(int(g.get_cells()[0]))
    g.stop_refining()
    pc = Particles(g, max_particles_per_cell=64, dtype=dtype)
    assert pc._dev_rebucket is not None
    s = pc.new_state(np.random.default_rng(42).uniform(0.0, 1.0, size=(120, 3)))
    return pc, pc.run(s, 5, velocity=(0.03, 0.02, 0.11), dt=0.5)


def _per_cell(pc, s):
    """Every cell's count and coordinates (a collective), by cell id."""
    from dccrg_tpu_torch.utils.collectives import fetch

    g = pc.grid
    pos = g.leaves.position(g.get_cells())
    d, r = g.leaves.owner[pos], g.epoch.row_of[pos]
    cnt = fetch(s["number_of_particles"])[d, r]
    xyz = fetch(s["particles"])[d, r].copy()
    xyz[np.arange(pc.P)[None, :] >= cnt[:, None]] = 0.0
    return cnt, xyz


def particles_record(pc, s):
    cnt, xyz = _per_cell(pc, s)
    return {"count": pc.count(s), "lost": pc.lost(s), "counts": _hash(cnt),
            "coords": _hash(xyz), "positions": _hash(pc.positions(s))}


def particles_s8_case(ctl, D):
    pc, s = particles_s8(ctl, D)
    rec = particles_record(pc, s)
    assert rec["count"] == 120 and rec["lost"] == 0, rec
    cells = pc.grid.get_cells()
    rec["particles_of"] = _hash(np.concatenate(
        [pc.particles_of(s, int(c)).reshape(-1) for c in cells[::3]]))
    return rec


def particles_adapt(ctl, D, host=False):
    """Particles on a periodic 4x4x12 grid (a stretched geometry with
    ``host``: the host re-bucket) through a refinement, an HSFC
    ``balance_load`` and ``remap`` after each, three steps between."""
    from dccrg_tpu_torch import Grid, Particles, StretchedCartesianGeometry

    if host:
        z = np.cumsum(np.r_[0.0, 1.05 ** np.arange(12)])
        g = (Grid().set_initial_length((4, 4, 12)).set_maximum_refinement_level(1)
             .set_neighborhood_length(1).set_periodic(True, True, True)
             .set_geometry(StretchedCartesianGeometry,
                           coordinates=(np.linspace(0, 1, 5), np.linspace(0, 1, 5),
                                        z / z[-1]))
             .initialize(n_devices=D, device="cpu", controllers=ctl))
    else:
        g = _grid(ctl, D, (4, 4, 12), max_ref=1, hood=1, periodic=(True,) * 3,
                  cell=(0.25, 0.25, 1 / 12))
    pc = Particles(g, max_particles_per_cell=48, dtype=np.float64)
    assert (pc._dev_rebucket is None) == host
    s = pc.new_state(np.random.default_rng(11).uniform(0.0, 1.0, size=(150, 3)))
    vel = pc.velocity_field(lambda c: 0.02 + 0.05 * np.sin(2 * np.pi * c))
    s = pc.run(s, 3, velocity=vel, dt=0.5)
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5,
                                                axis=1) < 0.3])
    g.stop_refining()
    s = pc.remap(s)
    s = pc.run(s, 3, velocity=(0.03, -0.02, 0.05), dt=0.5)
    g.set_partitioning_option("LB_METHOD", "HSFC")
    g.balance_load()
    s = pc.remap(s)
    s = pc.run(s, 3, velocity=pc.velocity_field(lambda c: 0.04 * np.cos(2 * np.pi * c)),
               dt=0.5)
    return pc, s


def particles_adapt_case(ctl, D, host=False):
    pc, s = particles_adapt(ctl, D, host)
    rec = particles_record(pc, s)
    rec["owner"] = _hash(pc.grid.leaves.owner.astype(np.int64))
    assert rec["count"] + rec["lost"] == 150, rec
    return rec


def flat_adv_setup(ctl, D, form, periodic_z=True):
    """Refined advection on the 4x4x24 ``BLOCK`` grid: one level refined
    for ``sharded`` and ``boxed`` (f32), two for ``ml`` (f64); a seeded
    density, vz and vy; the model, state and dt."""
    from dccrg_tpu_torch import Advection

    g = refined_poisson_grid(ctl, D, periodic_z, 2 if form == "ml" else 1)
    dtype = np.float64 if form == "ml" else np.float32
    adv = Advection(g, dtype=dtype)
    assert adv._flat_kind == ("ml" if form == "ml" else "sharded"), adv._flat_kind
    assert not adv._prefer_boxed
    s = adv.initialize_state()
    ids = g.get_cells()
    cen = g.geometry.get_center(ids)
    # density on every cell, the z ends included: an open z end loses mass
    s = adv.set_cell_data(s, "density", ids,
                          (1.0 + 0.5 * np.sin(2 * np.pi * cen.sum(1))).astype(dtype))
    s = adv.set_cell_data(s, "vz", ids, (0.3 * np.sin(2 * np.pi * cen[:, 2])).astype(dtype))
    s = adv.set_cell_data(s, "vy", ids, (0.2 + 0.1 * np.cos(2 * np.pi * cen[:, 1])).astype(dtype))
    s = g.update_copies_of_remote_neighbors(s)
    return adv, s, 0.3 * adv.max_time_step(s)


def flat_adv_case(ctl, D, form, periodic_z=True, steps=6):
    adv, s, dt = flat_adv_setup(ctl, D, form, periodic_z)
    run = adv._boxed_run if form == "boxed" else adv._flat_run.run
    ring = run.ring
    b0 = ring.transport_bytes
    out = run(s, steps, dt)
    ids = adv.grid.get_cells()
    rho = adv.get_cell_data(out, "density", ids)
    return {"kind": adv._flat_kind, "density": _hash(rho),
            "mass": adv.total_mass(out), "run_bytes": ring.transport_bytes - b0}


#: the cases of :func:`model_scenarios`, by name
MODEL_CASES = {
    "poisson_s6": lambda c, D: poisson_case(c, D, poisson_s6),
    "poisson_flat": lambda c, D: poisson_case(
        c, D, lambda c, D: poisson_solve(c, D, "flat", False)),
    "poisson_rolled": lambda c, D: poisson_case(
        c, D, lambda c, D: poisson_solve(c, D, "rolled")),
    "poisson_gather": lambda c, D: poisson_case(
        c, D, lambda c, D: poisson_solve(c, D, "gather", False)),
    "flat_apply_periodic": lambda c, D: flat_apply_case(c, D, True),
    "flat_apply_open": lambda c, D: flat_apply_case(c, D, False),
    "flat_apply_three_level": lambda c, D: flat_apply_case(c, D, False, 2),
    "particles_s8": particles_s8_case,
    "particles_adapt": particles_adapt_case,
    "particles_host": lambda c, D: particles_adapt_case(c, D, host=True),
    "adv_sharded_periodic": lambda c, D: flat_adv_case(c, D, "sharded", True),
    "adv_sharded_open": lambda c, D: flat_adv_case(c, D, "sharded", False),
    "adv_ml": lambda c, D: flat_adv_case(c, D, "ml", False),
    "adv_boxed": lambda c, D: flat_adv_case(c, D, "boxed", True),
}


def model_scenarios(ctl, nproc: int, D: int) -> dict:
    """Every case of MODEL_CASES on D slots (the one-controller oracle runs
    them on the same slots alone)."""
    res = {"nproc": nproc, "n_devices": D}
    for name, case in MODEL_CASES.items():
        res[name] = case(ctl, D)
    return res


# ------------- the split steps (D6), the lineage (D9) and the cohorts (D7)

#: the controllers' environment for the small cases: one compute thread a
#: process (several controllers share the CPU; torch's default of a thread
#: a core would oversubscribe it many times over)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def launch(mode, nproc, D, wd, *extra, timeout_s=120, backend=None, env=None):
    """``mode`` of this worker as ``nproc`` controllers of D slots over the
    payload transport ``backend`` (None: ``DCCRG_TORCH_DIST_BACKEND``,
    else gloo)."""
    from dccrg_tpu_torch.parallel import mesh

    backend = backend or os.environ.get(mesh.ENV_BACKEND) or "gloo"
    e = {**ONE_THREAD, mesh.ENV_BACKEND: backend, **(env or {})}
    return mesh.launch([sys.executable, os.path.abspath(__file__), str(D), wd, mode,
                        *map(str, extra)], nproc, timeout_s=timeout_s, env=e)


def shared_run(request, tmp_path_factory, tag, run):
    """``run(workdir)`` once a test session: under xdist the first worker to
    ask runs it and the others read its JSON result through a file lock in
    the run's shared temporary root."""
    import json

    if not hasattr(request.config, "workerinput"):
        return json.loads(json.dumps(run(str(tmp_path_factory.mktemp(tag)))))
    from filelock import FileLock

    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{tag}.json"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return json.loads(path.read_text())
        wd = root / tag
        wd.mkdir(exist_ok=True)
        out = run(str(wd))
        path.write_text(json.dumps(out))
        return json.loads(path.read_text())


@contextlib.contextmanager
def _env(**kw):
    """The environment with ``kw`` set, restored after."""
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _twins():
    """B9's twin calls so far (the ``pallas`` backend on CPU tensors)."""
    from dccrg_tpu_torch.ops import PLAIN_CALLS

    return PLAIN_CALLS["ring_copy"]


def split_grid(ctl, D, hood=0, length=(8, 8, 12)):
    """A periodic grid with the ball r < 0.3 refined once: inner and outer
    rows on 6 and 8 slots."""
    g = _grid(ctl, D, length, max_ref=1, hood=hood, periodic=(True,) * 3,
              cell=tuple(1.0 / n for n in length))
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5,
                                                axis=1) < 0.3])
    g.stop_refining()
    return g


def split_models(ctl, D, kind, dtype=np.float64, periodic=True):
    """(grid, the blocking gather model, the split-phase model, state, dt)
    of ``kind`` (advection, vlasov, gol) on B9's twin: Advection and
    Vlasov (nv = 2) on :func:`split_grid` at neighbourhood length 0, Game
    of Life on a 12 x 12 board at 30% alive."""
    from dccrg_tpu_torch import Advection, GameOfLife, Vlasov

    with _env(DCCRG_HALO_BACKEND="pallas"):
        if kind == "gol":
            g = _grid(ctl, D, (12, 12, 1))
            eager, split = GameOfLife(g, allow_dense=False), GameOfLife(g, overlap=True)
            cells = g.get_cells()
            s = eager.new_state(alive_cells=cells[np.random.default_rng(4).random(len(cells))
                                                  < 0.3])
            return g, eager, split, s, None
        if kind == "advection":
            g = split_grid(ctl, D)
            eager = Advection(g, allow_dense=False, use_kernels=False)
            split = Advection(g, allow_dense=False, overlap=True)
            s = eager.initialize_state()
            return g, eager, split, s, 0.4 * eager.max_time_step(s)
        length = (8, 8, 12)
        g = _grid(ctl, D, length, max_ref=1, hood=0, periodic=(True, True, periodic),
                  cell=tuple(1.0 / n for n in length))
        ids = g.get_cells()
        g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5,
                                                    axis=1) < 0.3])
        g.stop_refining()
        eager = Vlasov(g, nv=2, dtype=dtype)
        split = Vlasov(g, nv=2, dtype=dtype, overlap=True)
        s = eager.initialize_state()
        return g, eager, split, s, eager._scalar(0.4 * eager.max_time_step())


#: the fields each split case reads back by cell id
SPLIT_FIELDS = {"advection": ("density",), "vlasov": ("f",),
                "gol": ("is_alive", "live_neighbor_count")}


def split_case(ctl, D, kind, dtype=np.float64, periodic=True, steps=3):
    """``steps`` split steps, each bitwise equal to the blocking gather
    step, then a split ``run(2)``; the fields by cell id, B9's twin calls a
    split step and whether any row is inner."""
    import torch

    g, eager, split, s, dt = split_models(ctl, D, kind, dtype, periodic)
    args = () if dt is None else (dt,)
    se = sf = s
    twins = 0
    for _ in range(steps):
        se = eager.step(se, *args)
        t0 = _twins()
        sf = split.step(sf, *args)
        twins += _twins() - t0
        for name in SPLIT_FIELDS[kind]:
            assert torch.equal(se[name], sf[name]), f"{kind}: split != gather ({name})"
    sf = split.run(sf, 2, *args)
    se = eager.run(se, 2, *args)
    ids = g.get_cells()
    out = {"twins_per_step": twins / steps,
           "inner": bool(g.epoch.hoods[None].inner_mask.any())}
    for name in SPLIT_FIELDS[kind]:
        assert torch.equal(se[name], sf[name]), f"{kind}: split run != gather run"
        out[name] = _hash(g.get_cell_data(sf, name, ids))
    return out


SPLIT_CASES = {
    "advection": lambda c, D: split_case(c, D, "advection"),
    "vlasov_f32_periodic": lambda c, D: split_case(c, D, "vlasov", np.float32, True),
    "vlasov_f64_open": lambda c, D: split_case(c, D, "vlasov", np.float64, False),
    "gol": lambda c, D: split_case(c, D, "gol", steps=6),
}


def split_scenarios(ctl, nproc: int, D: int) -> dict:
    res = {"nproc": nproc, "n_devices": D}
    for name, case in SPLIT_CASES.items():
        res[name] = case(ctl, D)
    return res


#: the lineage's fields (the gather Advection's row state)
LINEAGE_SPEC = {k: ((), np.float64) for k in ("density", "vx", "vy", "vz")}


def lineage_setup(ctl, D):
    """The gather Advection (f64) on a periodic 6^3 grid with every 7th of
    the first 70 cells refined: (grid, model, state, dt)."""
    from dccrg_tpu_torch import Advection

    g = _grid(ctl, D, (6, 6, 6), max_ref=1, hood=0, periodic=(True,) * 3,
              cell=(1 / 6,) * 3)
    g.refine_completely_many(g.get_cells()[:70:7])
    g.stop_refining()
    adv = Advection(g, allow_dense=False, use_kernels=False)
    s = adv.initialize_state()
    return g, adv, s, 0.3 * adv.max_time_step(s)


def lineage_land(g, spec_state):
    """A gather Advection and its full state on the re-landed grid ``g``
    (the lineage's fields by cell id, ghosts refreshed)."""
    from dccrg_tpu_torch import Advection

    adv = Advection(g, allow_dense=False, use_kernels=False)
    s = adv.initialize_state()
    ids = g.get_cells()
    for f in LINEAGE_SPEC:
        s = adv.set_cell_data(s, f, ids, g.get_cell_data(spec_state, f, ids))
    return adv, g.update_copies_of_remote_neighbors(s)


def lineage_case(ctl, D, target, wd):
    """Commits and ``latest_valid``; a commit torn on the writer (rejected
    on every controller); a torn newest generation every controller skips,
    and ``salvage_latest`` of it; ``rescale`` to ``target`` slots and two
    steps after it.  Returns the
    generations, the reasons and the hashes by cell id (leaves, owners,
    fields after the landing, density after the steps)."""
    from dccrg_tpu_torch.io.checkpoint import CheckpointError
    from dccrg_tpu_torch.resilience import CheckpointLineage, rescale
    from dccrg_tpu_torch.resilience.inject import plane
    from dccrg_tpu_torch.utils.collectives import barrier

    g, adv, s, dt = lineage_setup(ctl, D)
    lin = CheckpointLineage(os.path.join(wd, f"lineage_{D}_{target}_{int(ctl.multi)}"))
    ids = g.get_cells()
    out = {}
    s = adv.run(s, 2, dt)
    gens = [lin.commit(g, s, LINEAGE_SPEC, user_header=b"2")]
    s = adv.run(s, 2, dt)
    gens.append(lin.commit(g, s, LINEAGE_SPEC, user_header=b"4"))
    lg, ls, hdr, gen = lin.latest_valid(LINEAGE_SPEC, n_devices=D, device="cpu")
    for f in LINEAGE_SPEC:
        assert np.array_equal(lg.get_cell_data(ls, f, ids), g.get_cell_data(s, f, ids)), f
    out["commit"] = gens + [gen, hdr.decode()]
    # the writer's file torn: controller 0 rejects, every controller raises
    if ctl.rank == 0:
        plane.arm("checkpoint.torn_write", prob=1.0, seed=1, count=1)
    try:
        lin.commit(g, s, LINEAGE_SPEC)
        out["rejected"] = "missed"
    except CheckpointError as e:
        out["rejected"] = e.section
    plane.disarm("checkpoint.torn_write")
    # the newest generation torn after its commit: every controller skips it
    g3 = lin.commit(g, s, LINEAGE_SPEC, user_header=b"4b")
    if ctl.rank == 0:
        path = os.path.join(lin.directory, f"gen-{g3:06d}.dc")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    barrier("lineage.torn")
    _, _, hdr, gen = lin.latest_valid(LINEAGE_SPEC, n_devices=D, device="cpu")
    out["torn"] = [g3, gen, hdr.decode()]
    sg, ss, hdr, gen, lost = lin.salvage_latest(LINEAGE_SPEC, n_devices=D, device="cpu")
    sids = sg.get_cells()
    out["salvage"] = [gen, hdr.decode(), int(len(lost)), _hash(lost),
                      _hash(sg.get_cell_data(ss, "density", sids))]
    r = rescale(g, s, LINEAGE_SPEC, target, lineage=lin)
    ng = r.grid
    nids = ng.get_cells()
    out["rescale"] = {"generation": r.generation, "before": r.n_devices_before,
                      "after": r.n_devices_after, "direction": r.direction,
                      "ids": _hash(nids), "owner": _hash(ng.leaves.owner.astype(np.int64))}
    out["local_slots"] = [ng.slots.start, ng.slots.stop]
    for f in LINEAGE_SPEC:
        out["rescale"][f] = _hash(ng.get_cell_data(r.state, f, nids))
    adv2, s2 = lineage_land(ng, r.state)
    s2 = adv2.run(s2, 2, dt)
    out["after"] = {"density": _hash(ng.get_cell_data(s2, "density", nids)),
                    "mass": adv2.total_mass(s2)}
    return out


#: (the run's steps, a commit every so many): the killed run dies on
#: controller 1 right after its second commit
KILL_STEPS, KILL_EVERY = 12, 4


def lineage_run(ctl, D, wd, phase):
    """The killed-and-resumed run: ``kill`` steps from the start, committing
    every KILL_EVERY steps, with ``sigkill.post_commit`` armed on
    controller 1 to fire after its second commit; ``resume`` lands the
    newest valid generation and finishes the run.  ``one`` (the oracle) is
    the uninterrupted run.  Returns the density by cell id and where the
    run resumed."""
    from dccrg_tpu_torch.resilience import CheckpointLineage
    from dccrg_tpu_torch.resilience.inject import plane

    lin = CheckpointLineage(os.path.join(wd, "killed"))
    g, adv, s, dt = lineage_setup(ctl, D)
    step, gen = 0, None
    if phase == "resume":
        g, ls, hdr, gen = lin.latest_valid(LINEAGE_SPEC, n_devices=D, device="cpu")
        step = int(hdr.decode())
        adv, s = lineage_land(g, ls)
    elif phase == "kill" and ctl.rank == 1:
        plane.arm("sigkill.post_commit", prob=1.0, seed=0, count=1, after=1)
    while step < KILL_STEPS:
        s = adv.step(s, dt)
        step += 1
        if phase != "one" and step % KILL_EVERY == 0:
            lin.commit(g, s, LINEAGE_SPEC, user_header=str(step).encode())
    ids = g.get_cells()
    return {"density": _hash(g.get_cell_data(s, "density", ids)), "resumed_gen": gen,
            "mass": adv.total_mass(s)}


# -------------------------------------------------------------- cohorts (D7)

def _all_slots_hash(result, names):
    """Hash of the fields ``names`` of a member's state, every slot (a
    collective)."""
    from dccrg_tpu_torch.utils.collectives import fetch

    return _hash(np.concatenate([fetch(result[n]).reshape(-1).view(np.uint8)
                                 for n in names]))


def _solo(model, state, steps, dt=None):
    for _ in range(steps):
        state = model.step(state) if dt is None else model.step(state, dt)
    return state


def _counter(name):
    from dccrg_tpu_torch import obs

    return int(sum(obs.metrics.report()["counters"].get(name, {}).values()))


def _members(model, s0, fields, W, scale):
    """W member states: ``s0`` with its ``fields`` scaled by 1 + 0.1 w
    (``scale`` False: unchanged)."""
    out = []
    for w in range(W):
        s = {k: v.clone() for k, v in s0.items()}
        if scale:
            for f in fields:
                s[f] = s[f] * (1.0 + 0.1 * w)
        out.append(s)
    return out


def cohort_case(ctl, D, kind, W=4, k=3):
    """One cohort of W members of ``kind`` through ``Ensemble`` (the
    solo-replay oracle on), each member's result bitwise equal to its solo
    run on this controller.  Returns the members' hashes (every slot), the
    form, the twin calls and transport bytes a member-batched step."""
    import torch

    from dccrg_tpu_torch.serve import Ensemble

    fields = ("density",)
    with _env(DCCRG_HALO_BACKEND="pallas"):
        if kind in ("blocked", "plane", "plain"):
            model, s0, dt = adv_setup(ctl, D, kind, True)
            form = list(model.dense_kind)
            counter = lambda: model._extend.transport_bytes
        elif kind == "vlasov":
            model, s0, dt = vlasov_setup(ctl, D, np.float32, False)
            fields, form = ("f",), model._fused_block
            counter = lambda: model._extend.transport_bytes
        elif kind == "split":
            g, _, model, s0, dt = split_models(ctl, D, "advection")
            form = "split"
            counter = lambda: model._exchange.transport_bytes
        elif kind == "gol_overlap":
            g, _, model, s0, dt = split_models(ctl, D, "gol")
            fields, form = ("is_alive", "live_neighbor_count"), "gol.overlap"
            counter = lambda: model._exchange.transport_bytes
        else:
            raise ValueError(kind)
        spec = model.batch_step_spec()
        states = _members(model, s0, fields if kind != "gol_overlap" else (), W,
                          kind != "gol_overlap")
        m0 = _counter("ensemble.verify_mismatches")
        ens = Ensemble(verify=True, steps_per_dispatch=k)
        steps = [2 * k + 1 + w for w in range(W)]
        dts = [None if dt is None else dt * (1.0 - 0.05 * w) for w in range(W)]
        tickets = [ens.submit(model, s, steps=n, dt=d) for s, n, d in zip(states, steps, dts)]
        t0, b0 = _twins(), counter()
        ens.admit_pending()
        cohort = next(iter(ens.cohorts.values()))
        # one member-batched step, the oracle's solo replay off
        cohort._verify_on = False
        cohort.step(1)
        cohort._verify_on = True
        twins, sent = _twins() - t0, counter() - b0
        ens.run()
        assert len(ens.cohorts) == 1 and cohort.W == W
        out = {"kind": spec.kind, "form": form, "twins_first_step": twins,
               "bytes_first_step": sent,
               "mismatches": _counter("ensemble.verify_mismatches") - m0}
        # one member alone: the transport bytes of a solo step
        b0 = counter()
        _solo(model, states[0], 1, dts[0])
        out["solo_step_bytes"] = counter() - b0
        hashes = []
        for t, s, n, d in zip(tickets, states, steps, dts):
            ref = _solo(model, s, n, d)
            for f in fields:
                assert torch.equal(ref[f], t.result[f]), f"{kind}: member != solo ({f})"
            hashes.append(_all_slots_hash(t.result, fields))
        out["members"] = hashes
    return out


def wide_case(ctl, D, k=4):
    """The exchange-amortized cohort: the gather Advection (f64) on a
    periodic 6^3 grid at neighbourhood length 2, two members, ``k`` steps a
    dispatch; owned rows bitwise equal to the solo run."""
    import torch

    from dccrg_tpu_torch import Advection
    from dccrg_tpu_torch.serve import Ensemble

    with _env(DCCRG_HALO_BACKEND="pallas"):
        g = _grid(ctl, D, (6, 6, 6), hood=2, periodic=(True,) * 3, cell=(1 / 6,) * 3)
        adv = Advection(g, allow_dense=False)
        spec = adv.batch_step_spec()
        assert spec.wide is not None and spec.wide.budget >= 2, spec.wide
        s0 = adv.initialize_state()
        dt = 0.4 * adv.max_time_step(s0)
        states = _members(adv, s0, ("density",), 2, True)
        m0 = _counter("ensemble.verify_mismatches")
        ens = Ensemble(verify=True, steps_per_dispatch=k)
        tickets = [ens.submit(adv, s, steps=k + 1 + w, dt=dt) for w, s in enumerate(states)]
        ens.run()
        cohort = next(iter(ens.cohorts.values()))
        lm = torch.as_tensor(spec.wide.local_mask)
        hashes = []
        for w, (t, s) in enumerate(zip(tickets, states)):
            ref = _solo(adv, s, k + 1 + w, dt)
            assert torch.equal(ref["density"][lm], t.result["density"][lm])
            hashes.append(_hash(g.get_cell_data(t.result, "density", g.get_cells())))
        return {"budget": int(spec.wide.budget), "wide": cohort._wide is not None,
                "members": hashes,
                "mismatches": _counter("ensemble.verify_mismatches") - m0}


def deadline_case(ctl, D, n=8):
    """A deadline ``Ensemble``: ``n`` seeded scenarios on two dense grids
    (two cohorts), each with a deadline (this process's clock: they differ
    between controllers, and controller 0's decide), policy ``deadline``,
    the oracle on; every scenario retires bitwise equal to its solo run."""
    import time

    import torch

    from dccrg_tpu_torch.serve import Ensemble

    models = [adv_setup(ctl, D, "plain", True), adv_setup(ctl, D, "blocked", False)]
    rng = np.random.default_rng(9)
    ens = Ensemble(policy="deadline", verify=True)
    m0 = _counter("ensemble.verify_mismatches")
    now = time.perf_counter()
    runs = []
    for i in range(n):
        model, s0, dt = models[i % 2]
        s = {k: v.clone() for k, v in s0.items()}
        s["density"] = s["density"] * float(1.0 + rng.random())
        steps = int(rng.integers(3, 9))
        d = dt * float(0.5 + 0.5 * rng.random())
        t = ens.submit(model, s, steps=steps, dt=d, tenant=f"t{i % 3}",
                       deadline=now + float(rng.uniform(0.01, 5.0)))
        runs.append((model, s, steps, d, t))
    ens.run()
    hashes = []
    for model, s, steps, d, t in runs:
        assert t.status == "done"
        ref = _solo(model, s, steps, d)
        assert torch.equal(ref["density"], t.result["density"])
        hashes.append(_all_slots_hash(t.result, ("density",)))
    return {"members": hashes, "cohorts": len(ens.cohorts),
            "mismatches": _counter("ensemble.verify_mismatches") - m0}


def member_ring_check(ctl, D, W=3, per_slot=2):
    """The controller ring's planes of a member stack ``[W, D, per_slot, 2,
    5]`` against one controller's roll of every member, and one transport
    batch of two messages carrying all W members."""
    import torch

    from dccrg_tpu_torch.parallel.dense import HaloExtend
    from dccrg_tpu_torch.utils.collectives import fetch

    slots = ctl.local_slots(D)
    full = torch.arange(W * D * per_slot * 10, dtype=torch.float64).reshape(
        W, D, per_slot, 2, 5)
    ring = HaloExtend(D, ctl)
    below, above = ring.planes(full[:, slots.start:slots.stop].clone(), members=True)
    want_lo = torch.roll(full[:, :, -1:], 1, 1)[:, slots.start:slots.stop]
    want_hi = torch.roll(full[:, :, :1], -1, 1)[:, slots.start:slots.stop]
    assert torch.equal(below, want_lo) and torch.equal(above, want_hi)
    sent = 2 * W * 10 * 8 if ctl.multi else 0
    assert ring.transport_bytes == sent, (ring.transport_bytes, sent)
    assert (ring._transport.messages_sent if ctl.multi else 2) == 2
    return _hash(np.concatenate([fetch(below.transpose(0, 1).contiguous()).reshape(-1),
                                 fetch(above.transpose(0, 1).contiguous()).reshape(-1)]))


COHORT_CASES = {
    "dense_blocked": lambda c, D: cohort_case(c, D, "blocked"),
    "dense_plane": lambda c, D: cohort_case(c, D, "plane"),
    "dense_plain": lambda c, D: cohort_case(c, D, "plain"),
    "dense_vlasov": lambda c, D: cohort_case(c, D, "vlasov"),
    "split": lambda c, D: cohort_case(c, D, "split"),
    "gol_overlap": lambda c, D: cohort_case(c, D, "gol_overlap"),
    "wide": wide_case,
    "deadline": deadline_case,
}


def cohort_scenarios(ctl, nproc: int, D: int) -> dict:
    res = {"nproc": nproc, "n_devices": D, "ring": member_ring_check(ctl, D)}
    for name, case in COHORT_CASES.items():
        res[name] = case(ctl, D)
    return res


# ------------------------------------ the device-direct transport (D8, ipc)

#: the stress case's exchanges, and the controller that sleeps before each
#: merge (the last), and for how long (s)
IPC_STRESS_EXCHANGES = 50
IPC_STRESS_SLEEP_S = 0.004


def _mixed(g, gen=0):
    """An f64, an f32 (3,) and a uint32 field of every cell, distinct a
    generation (the halo phase's dtypes)."""
    cells = g.get_cells()
    c = cells.astype(np.int64)
    vals = {"a": np.sin(0.37 * c) + gen,
            "b": np.stack([1.5 * c + gen, -1.0 * c, 0.25 * c - gen], 1).astype(np.float32),
            "u": ((c * 2654435761 + 97 * gen) % 2**32).astype(np.uint32)}
    spec = {"a": ((), np.float64), "b": ((3,), np.float32), "u": ((), np.uint32)}
    return g.state_from_host(spec, cells, vals)


def _state_hash(s):
    """Every slot's every row of every field (ghost rows included; a
    collective)."""
    from dccrg_tpu_torch.utils.collectives import fetch

    return _hash(np.concatenate([np.ascontiguousarray(fetch(s[k])).reshape(-1).view(np.uint8)
                                 for k in sorted(s)]))


def ipc_halo(ctl, D):
    """The blocking and the split exchange of a mixed-dtype state on a
    refined grid (ghost rows of every slot), and the same through
    ``MemberExchange`` for W = 3 member stacks, blocking and split, each
    member against its own exchange."""
    import torch

    from dccrg_tpu_torch.parallel.halo import MemberExchange, ring_args

    g = split_grid(ctl, D, hood=1)
    s = _mixed(g)
    out = {"blocking": _state_hash(g.update_copies_of_remote_neighbors(s))}
    h = g.start_remote_neighbor_copy_updates(_mixed(g, 1))
    out["split"] = _state_hash(g.wait_remote_neighbor_copy_updates(_mixed(g, 1), h))
    ex = g.halo()
    names = sorted(s)
    args = {k: v.unsqueeze(0) for k, v in ring_args(ex, names).items()}
    W = 3
    members = [_mixed(g, 10 + w) for w in range(W)]
    stack = {k: torch.stack([m[k] for m in members]) for k in names}
    mx = MemberExchange(ex, args, W)
    want = [g.update_copies_of_remote_neighbors(m) for m in members]
    got = mx(stack)
    got_split = mx.finish(stack, mx.start(stack))
    for w in range(W):
        for k in names:
            assert torch.equal(got[k][w], want[w][k]), ("member", w, k)
            assert torch.equal(got_split[k][w], want[w][k]), ("member split", w, k)
    out["members"] = [_state_hash({k: got[k][w] for k in names}) for w in range(W)]
    return out


def ipc_stress(ctl, D, n=IPC_STRESS_EXCHANGES):
    """``n`` back-to-back exchanges whose payload changes every generation,
    split and blocking in turn; the last controller sleeps before each
    merge.  Before an exchange every refreshed ghost row is poisoned (-1);
    after it each must hold its owner's value of this generation: a stale
    or torn row is counted.  Returns that count, the rows checked on this
    controller and the last generation's state (every slot's rows)."""
    import time

    import torch

    g = split_grid(ctl, D, hood=1)
    cells = g.get_cells()
    st = g.state_from_host({"id": ((), np.float64), "v": ((3,), np.float64)}, cells,
                           {"id": cells.astype(np.float64),
                            "v": np.zeros((len(cells), 3))})
    st = g.update_copies_of_remote_neighbors(st)
    ex = g.halo()
    ghost = torch.from_numpy(ex._rings_for_field("v").merge.cpu().numpy() >= 0)
    ids = st["id"].reshape(-1)
    late = ctl.multi and ctl.rank == ctl.size - 1
    bad = checked = 0
    for gen in range(n):
        v = torch.stack([ids * 1e-3 + gen, -ids - gen, ids + 0.5 * gen], 1)
        v[ghost] = -1.0
        s = {"v": v.reshape(st["v"].shape)}
        if gen % 2:
            h = g.start_remote_neighbor_copy_updates(s)
            if late:
                time.sleep(IPC_STRESS_SLEEP_S)
            s = g.wait_remote_neighbor_copy_updates(s, h)
        else:
            if late:
                time.sleep(IPC_STRESS_SLEEP_S)
            s = g.update_copies_of_remote_neighbors(s)
        got = s["v"].reshape(-1, 3)[ghost]
        i = ids[ghost]
        want = torch.stack([i * 1e-3 + gen, -i - gen, i + 0.5 * gen], 1)
        bad += int((got != want).any(dim=1).sum())
        checked += int(ghost.sum())
    return {"torn_or_stale": bad, "last": _state_hash(s)}, checked


def ipc_growth(ctl, D):
    """An exchange, then an epoch change (a refinement) and an exchange of
    a field 128 f64 wide: under ``ipc`` the arenas grow (collectively) at
    the new schedule's first exchange.  Returns the hashes and the arenas'
    growth count before and after."""
    arena = getattr(ctl, "arena", None)
    g = split_grid(ctl, D, hood=1)
    out = {"before": _state_hash(g.update_copies_of_remote_neighbors(_mixed(g)))}
    epoch0 = None if arena is None else arena.epoch
    ids = g.get_cells()
    lv = g.mapping.get_refinement_level(ids)
    g.refine_completely_many(ids[(lv == 0) & (g.geometry.get_center(ids)[:, 2] < 0.3)])
    g.stop_refining()
    cells = g.get_cells()
    wide = np.cos(np.outer(cells.astype(np.float64), np.arange(128) + 1.0))
    s = g.state_from_host({"w": ((128,), np.float64)}, cells, {"w": wide})
    out["after"] = _state_hash(g.update_copies_of_remote_neighbors(s))
    out["n_leaves"] = int(len(cells))
    grew = None if arena is None else [epoch0, arena.epoch, arena.cap]
    return out, grew


def ipc_scenarios(ctl, nproc: int, D: int) -> dict:
    """The device-direct transport's cases (``tests/test_torch_transport_ipc.py``):
    the halo (blocking, split, member stacks), the controller ring's planes
    (``HaloExtend.cross``, the member ring), the staged balance rows (C3),
    a rolled Poisson solve, the particles' two exchanges, the stress case
    and the growth case.  ``transport`` says what carried them (excluded
    from the comparison across transports)."""
    from dccrg_tpu_torch.parallel.transport import STAGED

    res = {"nproc": nproc, "n_devices": D, "halo": ipc_halo(ctl, D),
           "ring": ring_check(ctl, D), "member_ring": member_ring_check(ctl, D),
           "staged": staged_unsigned(ctl, D)[0],
           "poisson_rolled": MODEL_CASES["poisson_rolled"](ctl, D),
           "particles": particles_s8_case(ctl, D)}
    res["stress"], checked = ipc_stress(ctl, D)
    res["growth"], grew = ipc_growth(ctl, D)
    arena = getattr(ctl, "arena", None)
    res["transport"] = {
        "backend": ctl.backend, "staged": dict(STAGED), "grew": grew,
        "stress_rows_checked": checked,
        "batches": None if arena is None else sum(arena._gen_out.values()),
        "in_flight": None if arena is None else arena._in_flight}
    return res


def _p2p(ctl, nproc):
    """The JAX worker's scenario 7 exchanges among explicit peer sets."""
    from dccrg_tpu_torch.utils.collectives import _P2PTransport, some_reduce_p2p

    pid = ctl.rank
    transport = _P2PTransport.get()
    pair_peer = {0: 1, 1: 0}.get(pid)
    if pair_peer is not None:
        v = some_reduce_p2p(np.uint64(5 + pid), [pair_peer])
        assert int(v) == (5 + pid) + (5 + pair_peer), v
        assert set(transport.sent_to) == {pair_peer}, transport.sent_to
        assert set(transport.received_from) == {pair_peer}
    else:
        v = some_reduce_p2p(np.uint64(7), [])
        assert int(v) == 7
        assert not transport.sent_to and not transport.received_from
    full = some_reduce_p2p(np.uint64(10 ** pid),
                           [p for p in range(nproc) if p != pid])
    assert int(full) == sum(10 ** p for p in range(nproc)), full
    if nproc >= 3:
        # 1 and 2 run a pair while 0 goes straight to the next clique
        if pid in (1, 2):
            v = some_reduce_p2p(np.uint64(pid), [3 - pid])
            assert int(v) == 3, v
        skew = some_reduce_p2p(np.uint64(pid), [p for p in range(nproc) if p != pid])
        assert int(skew) == sum(range(nproc)), skew
    big = np.full(200_000, float(pid + 1), np.float64)
    big_sum = some_reduce_p2p(big, [p for p in range(nproc) if p != pid])
    assert big_sum.shape == big.shape
    assert np.all(big_sum == sum(range(1, nproc + 1)))
    return int(full)


def _agreement(ctl, grid, D):
    """The JAX worker's scenario 9: diverging host mutators raise on every
    controller and leave nothing behind."""
    from dccrg_tpu_torch import Grid

    pid = ctl.rank
    try:
        grid.add_neighborhood(99, [(0, 0, 1)] if pid == 0 else [(0, 1, 0)])
        hood = "missed"
    except RuntimeError as e:
        hood = "raised" if "disagree" in str(e) else f"wrong:{e}"
    assert 99 not in grid.neighborhoods
    assert grid.add_neighborhood(5, [(0, 1, 0)])
    assert grid.remove_neighborhood(5)
    try:
        (Grid().set_initial_length((4 + pid, 4, 1)).set_neighborhood_length(1)
         .initialize(n_devices=D, device="cpu", controllers=ctl))
        init = "missed"
    except RuntimeError as e:
        init = "raised" if "disagree" in str(e) else f"wrong:{e}"
    return {"neighborhood": hood, "initialize": init}


def main() -> None:
    from dccrg_tpu_torch.parallel import mesh

    D = int(sys.argv[1])
    workdir = sys.argv[2] if len(sys.argv) > 2 else tempfile.gettempdir()
    mode = sys.argv[3] if len(sys.argv) > 3 else "scenarios"
    # the transport from DCCRG_TORCH_DIST_BACKEND (launch sets it)
    ctl = mesh.setup(device="cpu", timeout_s=90)
    try:
        if mode == "dense":
            res = dense_scenarios(ctl, ctl.size, D)
        elif mode == "models":
            res = model_scenarios(ctl, ctl.size, D)
        elif mode == "ring":
            res = {"ring": ring_check(ctl, D)}
        elif mode == "split":
            res = split_scenarios(ctl, ctl.size, D)
        elif mode == "cohorts":
            res = cohort_scenarios(ctl, ctl.size, D)
        elif mode == "ipc":
            res = ipc_scenarios(ctl, ctl.size, D)
        elif mode == "lineage":
            res = lineage_case(ctl, D, int(sys.argv[4]), workdir)
        elif mode in ("kill", "resume"):
            res = lineage_run(ctl, D, workdir, mode)
        else:
            res = scenarios(ctl, ctl.size, D, workdir)
    finally:
        mesh.teardown()
    mesh.result(res)


if __name__ == "__main__":
    main()
