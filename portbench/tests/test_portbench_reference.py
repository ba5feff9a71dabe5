"""The plain reference against the program at a tiny size: the same leaf
set, and the same densities to rounding on a uniform and a two-level grid."""
import numpy as np
import pytest
import torch

from portbench import load
from portbench.reference.advection import Reference
from portbench.systems.advection import System


def _config(tiny, name, n=None, ball=None, periodic=None):
    cfg = load.config(name, tiny)
    if n is not None:
        cfg["initial_length"] = n
    if ball is not None:
        cfg.pop("adapt", None)
        cfg["max_refinement_level"] = 1
        cfg["refine"] = [ball]
    if periodic is not None:
        cfg["periodic"] = periodic
    return cfg


@pytest.mark.parametrize("name,periodic", [
    ("adv_uniform_512", [True, True, True]),
    ("adv_amr_48", [True, True, True]),
    ("adv_amr_48", [True, False, True]),
    ("adv_amr_128", [True, True, True]),
])
def test_float64_gather_step_equals_reference(tiny, name, periodic):
    """The program's float64 gather step and the reference, 30 steps from the
    same density: the same scheme to float64 rounding."""
    from dccrg_tpu_torch import Advection

    cfg = _config(tiny, name, periodic=periodic)
    cfg["dtype"] = "float64"
    ref = Reference(cfg)
    sysm = System(cfg, "cpu", ref.request)
    assert np.array_equal(sysm.cells(), ref.ids)
    inp = ref.inputs(11)
    adv = Advection(sysm.grid, dtype=np.float64, use_kernels=False, allow_dense=False)
    st = adv.initialize_state()
    st = adv.set_cell_data(st, "density", ref.ids, inp["density"].astype(np.float64))
    st = sysm.grid.update_copies_of_remote_neighbors(st)
    dt = 0.4 * adv.max_time_step(st)
    traffic = {"cfl": 0.4, "k": 30}
    dt_ref, (exp,) = ref.expected("cpu", [inp["density"]], traffic)
    assert dt == pytest.approx(dt_ref, rel=1e-12)
    out = adv.run(st, 30, dt)
    got = np.asarray(adv.get_cell_data(out, "density", ref.ids), np.float64)
    assert np.abs(got - exp).max() <= 1e-12 * np.abs(exp).max()


def test_float32_paths_within_rounding(tiny):
    """The float32 dispatch (B5's twin here, the blocked step's twin on the
    uniform grid) within float32 rounding of the reference."""
    for name in ("adv_amr_48", "adv_uniform_512"):
        cfg = load.config(name, tiny)
        ref = Reference(cfg)
        sysm = System(cfg, "cpu", ref.request)
        inp = ref.inputs(3)
        st = sysm.load(inp)
        traffic = {"entry": "run", "k": 50, "cfl": 0.4}
        out, _ = sysm.chunk(st, traffic, lambda n: _Null())
        _, (exp,) = ref.expected("cpu", [inp["density"]], traffic)
        gap = np.abs(sysm.answer(out) - exp).max() / np.abs(exp).max()
        assert gap < 1e-5, (name, gap)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_leaf_ids_follow_dccrg_numbering(tiny):
    """The reference's ids and refinement request equal the program's on a
    grid with a refined ball (dccrg's numbering, independent code)."""
    cfg = _config(tiny, "adv_amr_48", n=[6, 5, 4],
                  ball={"centre": [0.4, 0.5, 0.5], "radius": 0.35})
    ref = Reference(cfg)
    sysm = System(cfg, "cpu", ref.request)
    assert len(ref.request) > 0
    assert np.array_equal(sysm.cells(), ref.ids)
    centres = sysm.grid.geometry.get_center(ref.ids)
    assert np.allclose(centres, ref.centres(), rtol=0, atol=1e-12)


def test_faces_conserve_and_tile(tiny):
    """Every leaf's faces cover its surface on a periodic grid: per axis, the
    area on its minus side equals the area on its plus side, and both equal
    its cross-section."""
    ref = Reference(load.config("adv_amr_48", tiny))
    f = ref.faces("cpu")
    n = len(ref.ids)
    length = torch.as_tensor(ref.lengths())
    for axis in range(3):
        m = f["axis"] == axis
        plus = torch.zeros(n, dtype=torch.float64).index_add_(0, f["a"][m], f["area"][m])
        minus = torch.zeros(n, dtype=torch.float64).index_add_(0, f["b"][m], f["area"][m])
        o1, o2 = (axis + 1) % 3, (axis + 2) % 3
        cross = length[:, o1] * length[:, o2]
        assert torch.allclose(plus, cross, rtol=1e-12, atol=0)
        assert torch.allclose(minus, cross, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["adv_amr_48", "adv_amr_128"])
def test_refinement_is_the_adapter_criterion(tiny, name):
    """The reference's own reading of ``adapter.hpp``'s criterion refines
    the level-0 cells that the program's ``check_for_adaptation`` and
    ``adapt_grid`` refine, from the same hump on the uniform grid."""
    from dccrg_tpu_torch import Advection, CartesianGeometry, Grid

    from portbench.reference.advection import hump

    cfg = load.config(name, tiny)
    ref = Reference(cfg)
    assert 0 < len(ref.request) < int(np.prod(cfg["initial_length"]))
    n = np.asarray(cfg["initial_length"])
    g = (Grid().set_initial_length(tuple(int(v) for v in n))
         .set_neighborhood_length(0).set_periodic(True, True, True)
         .set_maximum_refinement_level(1)
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n))
         .initialize(device="cpu"))
    adv = Advection(g, dtype=np.float64)
    st = adv.initialize_state()
    cells = g.get_cells()
    c = g.geometry.get_center(cells)
    a = cfg["adapt"]
    st = adv.set_cell_data(st, "density", cells,
                           hump(c[:, 0], c[:, 1], a["hump"]["centre"],
                                a["hump"]["radius"]))
    st = adv.check_for_adaptation(st, a["diff_increase"], a["diff_threshold"])
    adv.adapt_grid(st)
    assert np.array_equal(np.sort(np.asarray(g.get_cells(), np.uint64)), ref.ids)
