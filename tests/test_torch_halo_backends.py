"""The port's halo backends against the JAX package's (tests/test_halo_backends.py
and tests/test_cell_datatype.py mirrored), on the CPU.

The port's ``pallas`` backend is kernel B9 (``csrc/halo_dma.cu``); on CPU
tensors its wrapper runs the plain twin, so these tests hold the twin, the
schedule around it and the split-phase steps.  The JAX side is built under
``DCCRG_HALO_BACKEND=collective``, which tests/test_halo_backends.py holds
bit-identical to its Pallas form (its interpreter is slow).  Same seeded
numpy inputs to both packages; states are compared by cell id.

Tolerances: exchanges exact (bytes); split steps bitwise equal to the port's
eager steps; against the JAX package's split steps 1e-12 relative in float64
(advection) and 4 ULP in float32 (Vlasov: XLA-CPU may contract a multiply-add
the port rounds in two, tests/test_torch_vlasov.py), GoL alive sets exact.
"""
import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu.models import GameOfLife as JGameOfLife
from dccrg_tpu.models import Vlasov as JVlasov
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS
from dccrg_tpu_torch.parallel import halo_dma
from dccrg_tpu_torch.parallel.halo import HaloExchange

from test_torch_halo import _by_id
from test_torch_vlasov_kernel import assert_within_4ulp


def make_grid(pkg, n_dev=8, length=(10, 10, 1), max_ref=0, hood_len=1,
              refine_ball=None, periodic=False):
    """tests/test_halo_backends.py::make_grid without its balance_load (not
    ported), so both packages keep the same owners."""
    g = (pkg.Grid().set_initial_length(length)
         .set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(hood_len)
         .set_periodic(periodic, periodic, periodic))
    if refine_ball is not None:
        g.set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n for n in length))
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev)) if pkg is dccrg_tpu
         else g.initialize(n_devices=n_dev, device="cpu"))
    if refine_ball is not None:
        ids = g.get_cells()
        ctr = g.geometry.get_center(ids)
        g.refine_completely_many(ids[np.linalg.norm(ctr - 0.5, axis=1) < refine_ball])
        g.stop_refining()
    return g


def both(monkeypatch, backend="pallas", **kw):
    """(JAX grid on its collective backend, port grid on ``backend``)."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jg = make_grid(dccrg_tpu, **kw)
    jg.halo()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", backend)
    return jg, make_grid(dccrg_tpu_torch, **kw)


def rand_state(g, spec, seed=0, fill=0):
    rng = np.random.default_rng(seed)
    state = g.new_state(spec, fill=fill)
    cells = g.get_cells()
    for name, (shape, dtype) in spec.items():
        if np.issubdtype(dtype, np.floating):
            vals = rng.normal(size=(len(cells),) + shape).astype(dtype)
        else:
            vals = rng.integers(0, 7, size=(len(cells),) + shape).astype(dtype)
        state = g.set_cell_data(state, name, cells, vals)
    return state


def assert_bitwise(a, b):
    for name in a:
        assert np.asarray(a[name]).tobytes() == np.asarray(b[name]).tobytes(), name


SPECS = [
    {"v": ((), np.float64)},
    {"rho": ((), np.float32), "mom": ((3,), np.float32)},
    {"alive": ((), np.uint32)},
    {"flag": ((), np.uint8), "h": ((3,), np.float16)},
    {"b": ((), np.bool_)},
]
SPEC_IDS = ["f64-scalar", "f32-multifield", "u32", "u8-f16x3", "bool"]


# ------------------------------------------------------ backend selection


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv("DCCRG_HALO_BACKEND", raising=False)
    # auto: the kernel for a CUDA grid, the collective form on the CPU
    assert halo_dma.resolve_backend("cpu") == "collective"
    assert halo_dma.resolve_backend("cuda") == "pallas"
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "auto")
    assert halo_dma.resolve_backend(torch.device("cpu")) == "collective"
    # an explicit pallas never degrades, whatever the device
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    assert halo_dma.resolve_backend("cpu") == "pallas"
    monkeypatch.setenv("DCCRG_HALO_BACKEND", " Collective ")
    assert halo_dma.resolve_backend("cuda") == "collective"
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "")
    assert halo_dma.resolve_backend("cpu") == "collective"


def test_invalid_backend_env_raises(monkeypatch):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "quantum")
    with pytest.raises(ValueError, match="DCCRG_HALO_BACKEND"):
        halo_dma.resolve_backend("cpu")
    monkeypatch.delenv("DCCRG_HALO_BACKEND")
    g = make_grid(dccrg_tpu_torch)
    # read when a schedule is built, not when a grid is
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "quantum")
    with pytest.raises(ValueError, match="DCCRG_HALO_BACKEND"):
        HaloExchange(g.epoch, g.epoch.hoods[None], "cpu")


def test_backend_resolved_per_schedule(monkeypatch):
    """The backend is read when a schedule is built (the first ``halo()``
    after an epoch), as in the JAX package."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch)
    assert g.halo().backend == "pallas"
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    assert g.halo().backend == "pallas"          # cached for the epoch
    assert make_grid(dccrg_tpu_torch).halo().backend == "collective"


# ---------------------------------------------- B9 twin: exchange by cell id


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_pallas_exchange_matches_jax(monkeypatch, n_dev, spec):
    """The port's pallas exchange (B9's twin on the CPU) leaves every local
    and ghost row byte-for-byte equal to the JAX package's exchange, by cell
    id, per dtype and trailing shape, on the refined multi-ring schedule."""
    kw = dict(n_dev=n_dev, length=(8, 8, 8), max_ref=1, refine_ball=0.3, periodic=True)
    jg, pg = both(monkeypatch, **kw)
    ex = pg.halo()
    assert ex.backend == "pallas"
    assert ex.ring_distances == jg.halo().ring_distances
    assert ex.ring_sizes == jg.halo().ring_sizes
    if n_dev > 1:
        assert len(ex.ring_ks) >= 2, "want a multi-ring schedule"
    calls = PLAIN_CALLS["ring_copy"]
    launches = LAUNCHES["ring_copy"]
    out = pg.update_copies_of_remote_neighbors(rand_state(pg, spec))
    # one grouped gather moves every field
    assert PLAIN_CALLS["ring_copy"] == calls + (1 if n_dev > 1 else 0)
    assert LAUNCHES["ring_copy"] == launches          # no card here
    want = jg.update_copies_of_remote_neighbors(rand_state(jg, spec))
    assert _by_id(pg, out) == _by_id(jg, want)
    for name in spec:
        assert out[name].dtype == pg.new_state(spec)[name].dtype
        assert ex.bytes_moved({name: out[name]}) == jg.halo().bytes_moved({name: want[name]})
        assert ex.wire_bytes({name: out[name]}) == jg.halo().wire_bytes({name: want[name]})


def test_ring_copy_twin_is_the_flat_gather():
    """B9's function: one gather over every ring distance's flat source rows
    ((d - k) % D) * R + send row, and its twin refuses nothing on the CPU."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 2**32, size=(3, 5, 2), dtype=np.uint32))
    idx = torch.tensor([14, 0, 7, 7, 4], dtype=torch.int32)
    got, = halo_dma.ring_gather([(x, idx)])
    assert got.dtype == torch.uint32 and got.shape == (5, 2)
    assert np.array_equal(got.numpy(), x.numpy().reshape(15, 2)[idx.numpy()])
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        halo_dma.ring_gather([(x, idx.to("meta"))])


def test_flat_tables_follow_the_ring(monkeypatch):
    """The concatenated send table reads slot (d - k) % D's send rows for
    receiving slot d; the recv table lands on d's ghost rows, pads on the
    scratch row."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch, n_dev=4, length=(6, 6, 1))
    ex, R, D = g.halo(), g.epoch.R, 4
    send, recv = ex._rings.send.numpy(), ex._rings.recv.numpy()
    assert len(send) == len(recv) == sum(D * s for s in ex.ring_sizes) == ex.wire_cells
    pos = 0
    for k, S in zip(ex.ring_ks, ex.ring_sizes):
        for d in range(D):
            src, dst = send[pos:pos + S] // R, recv[pos:pos + S] // R
            assert (src == (d - k) % D).all() and (dst == d).all()
            pos += S


def test_ring_start_uses_the_schedule_backend(monkeypatch):
    """ring_start goes through B9's wrapper on the backend resolved when the
    schedule was built, in one grouped call for every field, and through
    the plain gather when the caller (the verify oracle) asks for the
    collective form."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch)
    ex = g.halo()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    wrapped = []

    def spy(jobs):
        wrapped.append(jobs)
        return halo_dma.ring_gather_plain(jobs)

    monkeypatch.setattr(halo_dma, "ring_gather", spy)
    state = rand_state(g, {"v": ((), np.float64), "w": ((3,), np.float32)})
    got = ex.ring_start(state)
    assert len(wrapped) == 1 and all(job[1] is ex._rings.send for job in wrapped[0])
    ref = ex.ring_start(state, "collective")
    for name, x in state.items():
        assert torch.equal(got[name], x.flatten(0, 1)[ex._rings.send.long()])
        assert torch.equal(got[name], ref[name])
    assert len(wrapped) == 1


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int8, torch.int16,
                                   torch.uint16, torch.float16, torch.bfloat16],
                         ids=str)
def test_ring_copy_twin_any_dtype(dtype):
    """B9 moves bytes: its twin takes 1- and 2-byte elements and odd row
    widths as the kernel does (16-, 8-, 4-, 2- or 1-byte words)."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(3, 6, 3 * dtype.itemsize), dtype=np.uint8)
    x = torch.from_numpy(raw).view(dtype)
    if dtype == torch.bool:
        x = x.to(torch.uint8).bitwise_and(1).to(torch.bool)
    idx = torch.tensor([17, 0, 9, 9, 5, 12], dtype=torch.int32)
    got, = halo_dma.ring_gather([(x, idx)])
    assert got.dtype == dtype and got.shape == (6, 3)
    want = x.view(torch.uint8) if dtype == torch.bool else x
    assert np.array_equal(got.view(want.dtype).reshape(6, -1).view(torch.uint8).numpy(),
                          want.reshape(18, -1)[idx.long()].view(torch.uint8).numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int16], ids=str)
def test_narrow_exchange_pallas_equals_collective(monkeypatch, dtype):
    """A bfloat16 or int16 field (no numpy twin for the JAX side of
    bfloat16) exchanges on the pallas backend byte-for-byte as on the
    collective one, ghosts included."""
    kw = dict(n_dev=8, length=(8, 8, 8), max_ref=1, refine_ball=0.3, periodic=True)
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    hc = make_grid(dccrg_tpu_torch, **kw).halo()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    gp = make_grid(dccrg_tpu_torch, **kw)
    assert hc.backend == "collective" and gp.halo().backend == "pallas"
    gen = torch.Generator().manual_seed(6)
    x = torch.randint(-2**15, 2**15, (8, gp.epoch.R, 2), generator=gen,
                      dtype=torch.int32).to(torch.int16).view(dtype)
    # a uniform scratch row, as new_state makes it
    # (test_torch_halo_tables.py holds a random one)
    x[:, -1] = 0
    want, got = hc({"w": x})["w"], gp.halo()({"w": x})["w"]
    assert got.dtype == dtype and not torch.equal(got.view(torch.int16), x.view(torch.int16))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ------------------------------------------------------- split vs blocking


@pytest.mark.parametrize("backend", ["collective", "pallas"])
def test_split_matches_blocking(monkeypatch, backend):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", backend)
    g = make_grid(dccrg_tpu_torch)
    state = rand_state(g, {"v": ((), np.float64), "n": ((2,), np.uint32)})
    blocking = g.update_copies_of_remote_neighbors(state)
    handle = g.start_remote_neighbor_copy_updates(state)
    assert handle.event is None                       # CPU: gathered in start
    merged = g.wait_remote_neighbor_copy_updates(state, handle)
    assert_bitwise(blocking, merged)
    assert_bitwise(blocking, g.wait_remote_neighbor_copy_updates(state))


def test_single_slot_split_is_empty():
    """D = 1: no ring distance, no gather, an empty handle, identity."""
    g = make_grid(dccrg_tpu_torch, n_dev=1)
    state = rand_state(g, {"v": ((), np.float64)})
    calls = PLAIN_CALLS["ring_copy"]
    handle = g.start_remote_neighbor_copy_updates(state)
    assert handle.payload == {"v": None}
    assert g.wait_remote_neighbor_copy_updates(state, handle)["v"] is state["v"]
    assert PLAIN_CALLS["ring_copy"] == calls


# ------------------------------------------------------- verify oracle


def test_verify_counts_and_detects_mismatch(monkeypatch):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    monkeypatch.setenv("DCCRG_HALO_VERIFY", "1")
    g = make_grid(dccrg_tpu_torch)
    ex = g.halo()
    state = rand_state(g, {"v": ((), np.float64), "w": ((3,), np.float32)})
    out = g.update_copies_of_remote_neighbors(state)
    assert ex.verify_checks == 2 and ex.verify_mismatches == {}
    handle = g.start_remote_neighbor_copy_updates(state)
    g.wait_remote_neighbor_copy_updates(state, handle)
    assert ex.verify_checks == 4 and ex.verify_mismatches == {}
    # a corrupted result is detected and counted, not raised
    tampered = {**out, "v": out["v"].clone()}
    tampered["v"][0, 0] += 1.0
    assert ex._verify_oracle(state, tampered) == 1
    assert ex.verify_mismatches == {"v": 1}
    # NaN payloads compare by bytes: a clean NaN exchange verifies
    nan = {"v": torch.full_like(state["v"], float("nan")), "w": state["w"]}
    assert ex._verify_oracle(nan, g.update_copies_of_remote_neighbors(nan)) == 0


def test_verify_env_gates_the_check(monkeypatch):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    monkeypatch.delenv("DCCRG_HALO_VERIFY", raising=False)
    g = make_grid(dccrg_tpu_torch)
    g.update_copies_of_remote_neighbors(rand_state(g, {"v": ((), np.float64)}))
    assert g.halo().verify_checks == 0


def test_verify_noop_on_collective_backend(monkeypatch):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    monkeypatch.setenv("DCCRG_HALO_VERIFY", "1")
    g = make_grid(dccrg_tpu_torch)
    g.update_copies_of_remote_neighbors(rand_state(g, {"v": ((), np.float64)}))
    assert g.halo().verify_checks == 0


# --------------------------------------------------- split-phase models


def _density(g, state):
    return g.get_cell_data(state, "density", np.sort(g.get_cells()))


def both_hood0(monkeypatch, **kw):
    """``both`` with the JAX grid at neighborhood length 0 on the same
    leaves and owners: the JAX package prices a coarse face once per entry
    of a length >= 1 neighbor list, so its length-0 step is the oracle of
    the port's length-1 step (tests/test_torch_face_tables.py)."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jg = make_grid(dccrg_tpu, **{**kw, "hood_len": 0})
    jg.halo()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    pg = make_grid(dccrg_tpu_torch, **kw)
    np.testing.assert_array_equal(jg.get_cells(), pg.get_cells())
    np.testing.assert_array_equal(jg.leaves.owner, pg.leaves.owner)
    return jg, pg


@pytest.mark.parametrize("n_dev", [1, 8])
def test_split_advection_bit_identical(monkeypatch, n_dev):
    """The port's split step equals its eager gather step bitwise, steps and
    run alike, and the JAX package's overlap=True step at neighborhood
    length 0 on the same leaves to 1e-12 (f64)."""
    kw = dict(n_dev=n_dev, length=(8, 8, 8), max_ref=1, refine_ball=0.3, periodic=True)
    jg, pg = both_hood0(monkeypatch, **kw)
    eager = dccrg_tpu_torch.Advection(pg, dtype=np.float64, allow_dense=False,
                                      use_kernels=False)
    fused = dccrg_tpu_torch.Advection(pg, dtype=np.float64, allow_dense=False, overlap=True)
    assert fused.dense is None and fused._flat_run is None and eager._flat_run is None
    jf = JAdvection(jg, dtype=np.float64, allow_dense=False, overlap=True)
    se, sf, sj = eager.initialize_state(), fused.initialize_state(), jf.initialize_state()
    dt = 0.4 * eager.max_time_step(se)
    for _ in range(4):
        se, sf, sj = eager.step(se, dt), fused.step(sf, dt), jf.step(sj, dt)
        assert torch.equal(se["density"], sf["density"])
        assert torch.equal(sf["flux"], torch.zeros_like(sf["flux"]))
    assert torch.equal(eager.run(se, 3, dt)["density"], fused.run(sf, 3, dt)["density"])
    want = _density(jg, sj)
    np.testing.assert_allclose(_density(pg, sf), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert fused.total_mass(sf) == pytest.approx(jf.total_mass(sj), rel=1e-12)


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_split_vlasov_matches_eager(monkeypatch, n_dev, periodic):
    """The port's split Vlasov step equals its eager general step bitwise
    and the JAX package's overlap=True step at neighborhood length 0 on the
    same leaves within 4 ULP (f32)."""
    kw = dict(n_dev=n_dev, length=(8, 8, 8), max_ref=1, refine_ball=0.3,
              periodic=periodic)
    jg, pg = both_hood0(monkeypatch, **kw)
    eager = dccrg_tpu_torch.Vlasov(pg, nv=3, dtype=np.float32)
    fused = dccrg_tpu_torch.Vlasov(pg, nv=3, dtype=np.float32, overlap=True)
    jf = JVlasov(jg, nv=3, dtype=np.float32, overlap=True)
    assert eager.info is None and fused.info is None
    assert fused._has_open == (not periodic)
    se, sf, sj = eager.initialize_state(), fused.initialize_state(), jf.initialize_state()
    dt = np.float32(0.5 * eager.max_time_step())
    ids = np.sort(pg.get_cells())
    for _ in range(3):
        se, sf, sj = eager.step(se, dt), fused.step(sf, dt), jf.step(sj, dt)
        assert torch.equal(se["f"], sf["f"])
        assert_within_4ulp(pg.get_cell_data(sf, "f", ids), jg.get_cell_data(sj, "f", ids))
    assert torch.equal(eager.run(se, 2, dt)["f"], fused.run(sf, 2, dt)["f"])


def test_split_vlasov_forces_row_layout(monkeypatch):
    """overlap=True pins the general row layout even on a slab grid."""
    monkeypatch.delenv("DCCRG_HALO_BACKEND", raising=False)
    g = (dccrg_tpu_torch.Grid().set_initial_length((4, 4, 8)).set_neighborhood_length(1)
         .set_periodic(True, True, True)
         .set_geometry(dccrg_tpu_torch.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(0.25, 0.25, 0.125))
         .initialize(n_devices=8, device="cpu"))
    assert dccrg_tpu_torch.Vlasov(g, nv=2).info is not None
    vl = dccrg_tpu_torch.Vlasov(g, nv=2, overlap=True)
    assert vl.info is None
    state = vl.initialize_state()
    m0 = vl.total_mass(state)
    state = vl.run(state, 4, 0.5 * vl.max_time_step())
    assert abs(vl.total_mass(state) - m0) < 1e-6


def test_gol_overlap_matches_jax(monkeypatch):
    jg, pg = both(monkeypatch)
    glider = [35, 36, 37, 27, 16]
    jo, po = JGameOfLife(jg, overlap=True), dccrg_tpu_torch.GameOfLife(pg, overlap=True)
    assert po.dense2d is None and po.tables is None
    sj, sp = jo.new_state(alive_cells=glider), po.new_state(alive_cells=glider)
    for _ in range(6):
        sj, sp = jo.step(sj), po.step(sp)
        assert set(po.alive_cells(sp).tolist()) == set(jo.alive_cells(sj).tolist())
    ids = pg.get_cells()
    np.testing.assert_array_equal(pg.get_cell_data(sp, "live_neighbor_count", ids),
                                  jg.get_cell_data(sj, "live_neighbor_count", ids))


# ---------------------------------------------- cell_datatype (mirrored)


def even_cells_only(field, cell_ids, sender, receiver, hood_id):
    """rho travels only for even cell ids; aux always travels."""
    if field == "rho":
        return np.asarray(cell_ids, np.uint64) % 2 == 0
    return np.ones(len(cell_ids), bool)


def _ghost_map(g):
    """{(device, row): cell_id} for every ghost row."""
    ep = g.epoch
    return {(d, int(ep.n_local[d] + k)): int(ep.leaves.cells[pos])
            for d in range(g.n_devices) for k, pos in enumerate(ep.ghost_pos[d])}


def _states(g):
    st = g.new_state({"rho": ((), np.float64), "aux": ((), np.float64)}, fill=-1.0)
    cells = g.get_cells()
    st = g.set_cell_data(st, "rho", cells, cells.astype(np.float64))
    return g.set_cell_data(st, "aux", cells, 100.0 + cells.astype(np.float64))


def _policy_grid(pkg, max_ref=0):
    g = (pkg.Grid().set_initial_length((8, 8, 1)).set_neighborhood_length(1)
         .set_maximum_refinement_level(max_ref))
    return (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=8)) if pkg is dccrg_tpu
            else g.initialize(n_devices=8, device="cpu"))


@pytest.mark.parametrize("backend", ["collective", "pallas"])
def test_policy_gates_per_cell_per_field(monkeypatch, backend):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jg = _policy_grid(dccrg_tpu)
    want = jg.halo(None, cell_datatype=even_cells_only)(_states(jg))
    monkeypatch.setenv("DCCRG_HALO_BACKEND", backend)
    g = _policy_grid(dccrg_tpu_torch)
    st = _states(g)
    full = g.halo(None)(st)
    sel = g.halo(None, cell_datatype=even_cells_only)(st)
    checked = [0, 0]
    for (d, row), cid in _ghost_map(g).items():
        assert sel["aux"][d, row] == full["aux"][d, row] == 100.0 + cid
        if cid % 2 == 0:
            assert sel["rho"][d, row] == full["rho"][d, row] == cid
        else:
            assert sel["rho"][d, row] == -1.0     # keeps its fill value
        checked[cid % 2] += 1
    assert all(checked)
    assert _by_id(g, sel) == _by_id(jg, want)


def test_policy_reduces_wire_bytes(monkeypatch):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jg = _policy_grid(dccrg_tpu)
    g = _policy_grid(dccrg_tpu_torch)
    st = _states(g)
    full = g.halo(None)
    sel = g.halo(None, cell_datatype=even_cells_only)
    assert sel.bytes_moved(st) < full.bytes_moved(st)
    assert sel.wire_bytes(st) <= full.wire_bytes(st)
    only_aux = {"aux": st["aux"]}
    assert sel.bytes_moved(only_aux) == full.bytes_moved(only_aux)
    jsel, jst = jg.halo(None, cell_datatype=even_cells_only), _states(jg)
    assert sel.bytes_moved(st) == jsel.bytes_moved(jst)
    assert sel.wire_bytes(st) == jsel.wire_bytes(jst)


@pytest.mark.parametrize("backend", ["collective", "pallas"])
def test_split_phase_matches_blocking_under_policy(monkeypatch, backend):
    monkeypatch.setenv("DCCRG_HALO_BACKEND", backend)
    g = _policy_grid(dccrg_tpu_torch)
    st = _states(g)
    h = g.halo(None, cell_datatype=even_cells_only)
    blocking = h(st)
    merged = h.finish(st, h.start(st))
    assert_bitwise(blocking, merged)
    with pytest.raises(ValueError, match="field set"):
        h.finish({"rho": st["rho"]}, h.start(st))


def test_grid_level_policy_and_epoch_rebuild():
    """set_cell_datatype installs the policy for the default ``halo()``
    route; an epoch rebuild (here a refinement) builds the schedule again
    against the new send lists with the same policy."""
    g = _policy_grid(dccrg_tpu_torch, max_ref=1)
    g.set_cell_datatype(even_cells_only)
    out = g.update_copies_of_remote_neighbors(_states(g))
    odd = [(d, r) for (d, r), cid in _ghost_map(g).items() if cid % 2 == 1]
    assert odd and all(out["rho"][d, r] == -1.0 for d, r in odd)
    assert g.halo(cell_datatype=None) is not g.halo()

    old = g.halo()
    g.refine_completely(28)
    g.stop_refining()
    assert g.halo() is not old
    out2 = g.update_copies_of_remote_neighbors(_states(g))
    gm2 = _ghost_map(g)
    assert any(cid > 64 for cid in gm2.values())     # refined children
    for (d, r), cid in gm2.items():
        assert out2["rho"][d, r] == (-1.0 if cid % 2 else float(cid))

    g.set_cell_datatype(None)
    out3 = g.update_copies_of_remote_neighbors(_states(g))
    assert all(out3["rho"][d, r] == cid for (d, r), cid in _ghost_map(g).items())


def test_policy_sees_the_pair():
    """The policy receives (sender, receiver, hood_id) of each pair."""
    g = _policy_grid(dccrg_tpu_torch)
    seen = set()

    def spy(field, cell_ids, sender, receiver, hood_id):
        seen.add((sender, receiver, hood_id))
        return np.zeros(len(cell_ids), bool)

    st = _states(g)
    out = g.halo(None, cell_datatype=spy)(st)
    assert seen and all(s != r and h is None for (s, r, h) in seen)
    assert out["rho"] is st["rho"]                   # nothing selected


def test_bad_mask_shape_raises():
    g = _policy_grid(dccrg_tpu_torch)

    def bad(field, cell_ids, sender, receiver, hood_id):
        return np.ones(3, bool)

    with pytest.raises(ValueError, match="mask"):
        g.halo(None, cell_datatype=bad)(_states(g))
