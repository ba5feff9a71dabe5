"""One controller of the port's multi-controller tests
(``tests/test_torch_multiprocess.py``).

Run as ``python tests/torch_multiproc_worker.py D`` by
``dccrg_tpu_torch.parallel.mesh.launch`` (the controllers' environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), it joins the
gloo group on the CPU, runs the JAX package's multi-controller scenarios 1-5,
7 and 9 (``tests/multiproc_worker.py``) on a grid of D slots, plus the
gather advection with per-controller adaptation requests and balance, and
prints one ``RESULT {json}`` line.  :func:`scenarios` with the single
controller is the one-controller oracle: it applies every rank's requests
itself, in rank order.
"""
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

    # ---- 7: point-to-point Some_Reduce
    counts = np.asarray([g.get_local_cell_count(d) for d in range(D)], np.uint64)
    res["some_reduce"] = {"device0": int(some_reduce(g, counts, 0))}
    if ctl.multi:
        res["some_reduce"]["clique"] = _p2p(ctl, nproc)

    # ---- 9: enforced agreement for host mutators
    if ctl.multi:
        res["agreement"] = _agreement(ctl, g, D)
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
    ctl = mesh.setup(backend="gloo", device="cpu", timeout_s=90)
    try:
        res = scenarios(ctl, ctl.size, D, workdir)
    finally:
        mesh.teardown()
    mesh.result(res)


if __name__ == "__main__":
    main()
