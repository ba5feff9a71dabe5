"""The agreement helpers of ``dccrg_tpu_torch/utils/collectives.py`` in one
process, with a fake multi-process ``_process_allgather`` seam: P threads,
one a virtual controller, meet at a barrier and each gets every thread's
array.  The same fake drives the JAX package's ``utils/collectives.py``
(patched here, in the test only), and both must give equal results.  Also:
under P > 1 every path builds on this controller's slots."""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dccrg_tpu_torch.utils import collectives as TC


class FakeGroup:
    """An all-gather among ``P`` threads (each sets ``rank`` first)."""

    def __init__(self, P):
        self.P = P
        self.barrier = threading.Barrier(P, timeout=30)
        self.slots = [None] * P
        self.local = threading.local()

    def allgather(self, x):
        self.slots[self.local.rank] = np.array(x, copy=True)
        self.barrier.wait()
        out = np.stack(self.slots)
        self.barrier.wait()
        return out


def run_controllers(module, monkeypatch, P, fn):
    """``fn(rank)`` on P threads over ``module`` patched with a fake seam;
    returns each rank's return value or raised exception."""
    group = FakeGroup(P)
    monkeypatch.setattr(module, "process_count", lambda: P)
    monkeypatch.setattr(module, "_process_allgather", group.allgather)
    out = [None] * P

    def body(r):
        group.local.rank = r
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — compared by the test
            out[r] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


def both(monkeypatch, P, make):
    """``make(module)`` -> fn(rank), run on the port's and the JAX
    package's helpers; returns (port results, JAX results)."""
    from dccrg_tpu.utils import collectives as JC

    return (run_controllers(TC, monkeypatch, P, make(TC)),
            run_controllers(JC, monkeypatch, P, make(JC)))


def _norm(v):
    if isinstance(v, np.ndarray):
        return ("a", str(v.dtype), v.tolist())
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


REQUESTS = [
    [np.array([5, 9, 1], np.uint64), np.array([], np.uint64)],
    [np.array([9, 33], np.uint64), np.array([2], np.uint64)],
    [np.array([], np.uint64), np.array([2, 7, 7], np.uint64)],
]


@pytest.mark.parametrize("P", [2, 3])
def test_union_and_multi_gather(monkeypatch, P):
    def make(m):
        return lambda r: (m.union_u64(REQUESTS[r][0]),
                          m.allgather_u64_multi(REQUESTS[r]),
                          m.allgather_u64(REQUESTS[r][1]))

    port, jax_ = both(monkeypatch, P, make)
    for r in range(P):
        assert _norm(port[r]) == _norm(port[0]) == _norm(jax_[r])
    want = np.unique(np.concatenate([REQUESTS[r][0] for r in range(P)]))
    assert port[0][0].tolist() == want.tolist()


@pytest.mark.parametrize("P", [2, 3])
def test_sync_adaptation(monkeypatch, P):
    def make(m):
        def fn(r):
            q = SimpleNamespace(to_refine={3 + r, 100}, to_unrefine={40 * r},
                                not_to_refine={7} if r == P - 1 else set(),
                                not_to_unrefine=set())
            m.sync_adaptation(q)
            return {k: sorted(getattr(q, k)) for k in
                    ("to_refine", "to_unrefine", "not_to_refine", "not_to_unrefine")}
        return fn

    port, jax_ = both(monkeypatch, P, make)
    assert port == jax_
    assert all(r == port[0] for r in port)
    assert port[0]["to_refine"] == sorted({3 + r for r in range(P)} | {100})
    assert port[0]["not_to_refine"] == [7]


@pytest.mark.parametrize("P", [2, 3])
def test_sync_partition_inputs_rank_order(monkeypatch, P):
    """Conflicting pins and weights: the highest rank's entry wins; each
    controller's own dicts stay as they were."""
    def make(m):
        def fn(r):
            pins = {5: r, 10 + r: 0}
            weights = {5: 1.5 * (r + 1), 99: 2.0}
            got = m.sync_partition_inputs(pins, weights)
            assert pins == {5: r, 10 + r: 0}
            return got
        return fn

    port, jax_ = both(monkeypatch, P, make)
    assert port == jax_
    pins, weights = port[0]
    assert pins[5] == P - 1 and weights[5] == 1.5 * P
    assert {10 + r for r in range(P)} <= set(pins)


@pytest.mark.parametrize("differ", [None, 0, 2])
def test_assert_agreement(monkeypatch, differ):
    P = 3

    def make(m):
        def fn(r):
            payload = b"same" if r != differ else b"other"
            m.assert_agreement("Grid.initialize settings", payload)
            return "agreed"
        return fn

    port, jax_ = both(monkeypatch, P, make)
    for got in (port, jax_):
        if differ is None:
            assert got == ["agreed"] * P
        else:
            assert all(isinstance(e, RuntimeError) and "disagree" in str(e)
                       for e in got)
    if differ is not None:
        assert [str(e) for e in port] == [str(e) for e in jax_]


@pytest.mark.parametrize("op", [np.add, np.minimum, np.maximum])
def test_all_reduce(monkeypatch, op):
    vals = [[1.5, 4.0], [-2.0, 8.0], [0.25, 3.0]]

    def make(m):
        return lambda r: m.all_reduce([vals[r]], op)

    port, jax_ = both(monkeypatch, 3, make)
    for p, j in zip(port, jax_):
        assert np.array_equal(p, j)
    assert np.array_equal(port[0], op.reduce(np.asarray(vals), axis=0))


def test_identity_under_one_controller():
    assert TC.process_count() == 1
    pins, weights = {1: 0}, {2: 3.0}
    assert TC.sync_partition_inputs(pins, weights) == (pins, weights)
    TC.assert_agreement("x", b"anything")
    TC.barrier()
    assert TC.union_u64(np.array([3, 1, 3], np.uint64)).tolist() == [1, 3]
    x = torch.arange(6.0).reshape(2, 3)
    assert np.array_equal(TC.fetch(x), x.numpy())
    assert TC.some_reduce_p2p(np.uint64(4), [1, 2]) == 4


# ------------------------------------------------- paths across controllers

def _two_controllers():
    from dccrg_tpu_torch.parallel.mesh import Controllers

    return Controllers(rank=0, size=2, backend="gloo",
                       device=torch.device("cpu"))


def _grid(length, D=2, max_ref=0, hood=1, refine=False):
    from dccrg_tpu_torch import CartesianGeometry, Grid

    g = (Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(hood).set_periodic(True, True, length[2] > 1)
         .set_load_balancing_method("BLOCK")
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n for n in length))
         .initialize(n_devices=D, controllers=_two_controllers()))
    if refine:
        g.refine_completely(int(g.get_cells()[0]))
        g.stop_refining()
    return g


def _advection_overlap():
    from dccrg_tpu_torch import Advection

    return Advection(_grid((4, 4, 4), hood=0), overlap=True)._inner["rows"]


def _advection_cohort():
    from dccrg_tpu_torch import Advection

    adv = Advection(_grid((4, 4, 4), hood=0), allow_dense=False)
    return adv.batch_step_spec().args["nbr_rows"]


def _advection_wide():
    from dccrg_tpu_torch import Advection

    spec = Advection(_grid((6, 6, 6), hood=2), allow_dense=False)._wide_spec()
    assert spec is not None and spec.budget >= 2
    assert spec.local_mask.shape[0] == 1
    return spec.args["w.nbr_rows"]


def _gol_overlap():
    from dccrg_tpu_torch import GameOfLife

    return GameOfLife(_grid((6, 6, 1)), overlap=True)._sides[0][0]


def _gol_cohort():
    from dccrg_tpu_torch import GameOfLife

    return GameOfLife(_grid((6, 6, 1)), allow_dense=False).batch_step_spec().args["nbr_rows"]


def _vlasov_overlap():
    from dccrg_tpu_torch import Vlasov

    return Vlasov(_grid((4, 4, 4), hood=0), 2, overlap=True)._inner["rows"]


def _vlasov_cohort():
    from dccrg_tpu_torch import Vlasov

    vl = Vlasov(_grid((4, 4, 4), hood=0), 2)
    assert vl.batch_step_spec().kind == "vlasov.dense"
    return vl.initialize_state()["f"]


def _vlasov_split_cohort():
    from dccrg_tpu_torch import Vlasov

    vl = Vlasov(_grid((4, 4, 4), max_ref=1, hood=0, refine=True), 2, overlap=True)
    return vl.batch_step_spec().args["inner.bnd_pos"].transpose(0, 1)


def _ring_args():
    """The cohort ring tables: no ``full`` table, the payload table padded
    to the widest controller's, the parts a row a controller."""
    from dccrg_tpu_torch.parallel.halo import ring_args

    g = _grid((4, 4, 4), max_ref=1, hood=0, refine=True)
    args = ring_args(g.halo(), ["density"])
    assert "ring.density.full" not in args
    assert tuple(args["ring.density.parts"].shape) == (3, 3)
    assert args["ring.density.send"].shape[0] == g.halo()._rings.width
    return args["ring.density.merge"].view(1, -1)


@pytest.mark.parametrize("path", [
    _advection_overlap, _advection_cohort, _advection_wide, _gol_overlap,
    _gol_cohort, _vlasov_overlap, _vlasov_cohort, _vlasov_split_cohort, _ring_args,
], ids=lambda f: f.__name__.lstrip("_"))
def test_split_and_cohort_paths_build_across_controllers(path):
    """The split steps' tables, the cohorts' member tables and the wide
    plan's under P > 1 hold this controller's slots (controller 0 of 2 holds
    slot 0 of 2)."""
    assert path().shape[0] == 1


def test_no_path_is_guarded_across_controllers():
    from dccrg_tpu_torch.parallel import mesh

    assert not hasattr(mesh, "NOT_PORTED") and not hasattr(mesh, "require_single")


def test_gather_paths_build_across_controllers():
    """The ported paths build under P > 1 with this controller's slots:
    the gather steps, and the dense slab ring's paths (dense advection,
    the dense 2-D board, dense and row-layout Vlasov) with no
    ``allow_dense=False``."""
    from dccrg_tpu_torch import Advection, GameOfLife, Vlasov

    g = _grid((6, 6, 1))
    gol = GameOfLife(g, allow_dense=False)
    assert gol.tables.nbr_rows.shape[0] == 1
    assert gol.new_state()["is_alive"].shape[:2] == (1, g.epoch.R)
    adv = Advection(_grid((4, 4, 4), max_ref=1, hood=0, refine=True),
                    allow_dense=False, use_kernels=False)
    assert adv._flat_run is None and adv.tables.local_mask.shape[0] == 1

    dense = Advection(_grid((4, 4, 4), hood=0), dtype=np.float32)
    assert dense.dense is not None and not dense.fused
    assert dense.dense_kind == ("blocked_direct", 2)
    assert dense._extend.controllers.multi
    assert tuple(dense._mz_up.shape) == (1, 2)
    board = GameOfLife(_grid((6, 6, 1)))
    assert board.dense2d is not None and not board.fused
    assert board._ring.controllers.multi
    assert tuple(board._ok_below.shape) == (1, 1, 1)
    vl = Vlasov(_grid((4, 4, 4), hood=0), 2)
    assert vl.info is not None and vl._fused_block == 2
    assert tuple(vl.initialize_state()["f"].shape) == (1, 2, 4, 4, 8)
    rows = Vlasov(_grid((4, 4, 4), max_ref=1, hood=0, refine=True), 2)
    assert rows.info is None and rows._dev["bnd_pos"].shape[1] == 1


@pytest.mark.parametrize("space", ["flat", "rolled", "gather"])
def test_poisson_builds_across_controllers(space):
    """Poisson in each operator space under P > 1, this controller's slots
    only (controller 0 of 2 holds slot 0 of 2): the flat operator's block of
    z-slabs and its ring, the rolled and gather tables' rows."""
    from dccrg_tpu_torch import Poisson

    g = _grid((4, 4, 4), max_ref=1, hood=0, refine=True)
    p = Poisson(g, allow_flat=space == "flat", allow_rolled=space == "rolled")
    assert p.operator_space == space and p._solve_fast is None
    assert tuple(p._scaling.shape) == (1, g.epoch.R)
    assert tuple(p._solve_mask.shape) == (1, g.epoch.R)
    if space == "gather":
        assert tuple(p._mult_table(0).shape) == (1,) + g.epoch.hoods[None].nbr_rows.shape[1:]
    if space == "flat":
        _fwd, _rev, voxelize, writeback, masks = p._flat
        # 8 voxel planes over 2 slots: this controller's 4
        assert tuple(masks["solve"].shape) == (4, 8, 8)
        vox = voxelize(torch.ones(1, g.epoch.R, dtype=torch.float64))
        assert tuple(vox.shape) == (4, 8, 8)
        assert tuple(writeback(vox).shape) == (1, g.epoch.R)


def test_particles_build_across_controllers():
    """Particles under P > 1: the state, the re-bucket's tables and a
    velocity field hold this controller's slots."""
    from dccrg_tpu_torch import Particles

    g = _grid((4, 4, 4), max_ref=1, hood=1, refine=True)
    pc = Particles(g, 8, dtype=np.float64)
    assert pc._dev_rebucket is not None
    s = pc.new_state(np.random.default_rng(1).uniform(0, 1, (20, 3)))
    assert tuple(s["particles"].shape) == (1, g.epoch.R, 8, 3)
    assert tuple(s["number_of_particles"].shape) == (1, g.epoch.R)
    assert pc.velocity_field(lambda c: c).shape == (2, g.epoch.R, 3)
    assert tuple(pc._velocity(pc.velocity_field(lambda c: c)).shape) == (1, g.epoch.R, 3)


def _three_level_grid():
    g = _grid((4, 4, 8), max_ref=2, hood=0)
    for _ in range(2):
        ids = g.get_cells()
        lv = g.mapping.get_refinement_level(ids)
        g.refine_completely(int(ids[lv == lv.max()][0]))
        g.stop_refining()
    return g


@pytest.mark.parametrize("form", ["sharded", "ml", "boxed"])
def test_flat_forms_build_across_controllers(form):
    """Advection's refined run forms under P > 1: the ``sharded`` and
    ``ml`` flat forms and the boxed passes build on this controller's slots
    and its slab ring (``HaloExtend``'s controller form)."""
    from dccrg_tpu_torch import Advection

    if form == "ml":
        g = _three_level_grid()
    else:
        g = _grid((4, 4, 4), max_ref=1, hood=0, refine=True)
    adv = Advection(g, dtype=np.float32)
    assert adv._flat_kind == ("ml" if form == "ml" else "sharded")
    assert not adv._prefer_boxed
    if form == "boxed":
        assert adv._boxed_run is not None and adv.boxed.n_devices == 2
    else:
        assert adv._flat_run is not None
