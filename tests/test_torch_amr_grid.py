"""The port's adaptive refinement against the JAX package's: the same request
sets give the same leaf sets, new and removed cells, neighbor and face lists,
remapped states and epochs — exactly.

Rows are compared only where the JAX epoch was built in full
(``DCCRG_EPOCH_DELTA=0``): the JAX package patches its epoch incrementally
by default, and a patched epoch may give a leaf another row than the full
build the port always does, so there the comparison goes by cell id.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch


def _build(pkg, D, max_lvl, hood=1, periodic=(True, False, True), length=(6, 6, 4)):
    g = (
        pkg.Grid()
        .set_initial_length(length)
        .set_neighborhood_length(hood)
        .set_periodic(*periodic)
        .set_maximum_refinement_level(max_lvl)
        .set_geometry(
            pkg.CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / length[0], 1.0 / length[1], 1.0 / length[2]),
        )
    )
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))
    return g.initialize(n_devices=D, device="cpu")


def _rounds(g, max_lvl):
    """Request rounds, each a list of (method, argument) applied in order
    before one ``stop_refining``; ids are picked from the grid's own
    geometry, so both packages get the same requests."""
    cells = g.get_cells()
    c = g.geometry.get_center(cells)
    near = cells[np.linalg.norm(c - np.array([0.4, 0.5, 0.5]), axis=1) < 0.3]
    rounds = [[("refine_completely_many", near[1:]),
               ("refine_completely", near[0]),
               ("dont_refine", cells[-1]),
               ("refine_completely_at", (0.9, 0.1, 0.9))]]

    def second(g):
        cells = g.get_cells()
        lvl = g.mapping.get_refinement_level(cells)
        fine = cells[lvl == 1]
        ops = [("unrefine_completely_many", fine[::5]),
               ("dont_unrefine", fine[3]),
               ("unrefine_completely", fine[-1])]
        if max_lvl >= 2:
            # a level-1 cell whose level-0 face neighbors must refine too
            # (the 2:1 rule adds those refinements)
            edge = fine[np.argmax(g.geometry.get_center(fine)[:, 0])]
            ops += [("refine_completely", edge),
                    ("refine_completely_many", fine[1:40:7])]
        return ops

    def third(g):
        cells = g.get_cells()
        lvl = g.mapping.get_refinement_level(cells)
        top = cells[lvl == lvl.max()]
        return [("dont_unrefine_many", top[:2]),
                ("unrefine_completely_many", top[::3]),
                ("dont_refine_many", cells[lvl == 0][:4]),
                ("refine_completely_many", cells[lvl == 0][2::9]),
                ("unrefine_completely_at", tuple(g.geometry.get_center(top[-1:])[0]))]

    return rounds, second, third


def _apply(g, ops):
    for name, arg in ops:
        if isinstance(arg, np.ndarray) and arg.ndim == 1 and name.endswith("_many"):
            getattr(g, name)(arg)
        elif name.endswith("_at"):
            getattr(g, name)(np.asarray(arg, dtype=np.float64))
        else:
            getattr(g, name)(int(arg))
    return g.stop_refining(), g.get_removed_cells()


def _cycle(D, max_lvl):
    """Yields (jax grid, port grid, jax commit, port commit) per round."""
    ref, port = _build(dccrg_tpu, D, max_lvl), _build(dccrg_tpu_torch, D, max_lvl)
    first, second, third = _rounds(port, max_lvl)
    for make in (lambda g: first[0], second, third):
        ops = make(port)
        yield ref, port, _apply(ref, ops), _apply(port, ops)


def _neighbors_by_id(g, pos):
    """(neighbor ids, offsets) of the leaf at position ``pos``."""
    lists = g.epoch.hoods[None].lists
    ids, offs = lists.row(pos)
    return np.asarray(ids), np.asarray(offs)


CASES = [(1, 1), (3, 1), (1, 2), (3, 2)]


@pytest.mark.parametrize("D,max_lvl", CASES)
def test_commits_match_jax(D, max_lvl):
    """Leaf sets, new cells, removed cells, owners, neighbor (of and to)
    and face lists after every commit."""
    n_induced = 0
    for ref, port, (rn, rr), (pn, pr) in _cycle(D, max_lvl):
        np.testing.assert_array_equal(pn, rn)
        np.testing.assert_array_equal(pr, rr)
        np.testing.assert_array_equal(port.get_cells(), ref.get_cells())
        np.testing.assert_array_equal(port.leaves.owner, ref.leaves.owner)
        rd, pd = ref.get_last_adaptation_delta(), port.get_last_adaptation_delta()
        np.testing.assert_array_equal(pd.added, rd.added)
        np.testing.assert_array_equal(pd.removed, rd.removed)
        n_induced += len(pn)
        rl, pl = ref.epoch.hoods[None].lists, port.epoch.hoods[None].lists
        for name in ("start", "nbr_pos", "offset", "slot"):
            np.testing.assert_array_equal(getattr(pl, name), getattr(rl, name))
        for cell in port.get_cells()[::3]:
            assert port.get_face_neighbors_of(cell) == ref.get_face_neighbors_of(cell)
            np.testing.assert_array_equal(port.get_neighbors_to(cell),
                                          ref.get_neighbors_to(cell))
            assert port.get_refinement_level(cell) == ref.get_refinement_level(cell)
        pts = np.random.default_rng(D).uniform(0.0, 1.0, (64, 3))
        np.testing.assert_array_equal(port.get_existing_cell(pts),
                                      ref.get_existing_cell(pts))
    assert n_induced > 0


def test_two_to_one_adds_refinements():
    """Refining a level-1 cell beside level-0 cells refines those too, in
    both packages alike."""
    grids = [_build(p, 1, 2) for p in (dccrg_tpu, dccrg_tpu_torch)]
    out = []
    for g in grids:
        g.refine_completely(1)
        g.stop_refining()
        child = int(g.mapping.get_all_children(np.uint64(1))[-1])
        g.refine_completely(child)
        out.append((g.stop_refining(), g.get_cells()))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    # more than the requested cell's 8 children: the 2:1 fixed point added
    # the level-0 neighbors' children
    assert len(out[1][0]) > 8


_POLICIES = {
    "a": {"refine": "inherit", "unrefine": "mean"},
    "b": {"refine": "zero", "unrefine": "zero"},
    "c": {"refine": "inherit", "unrefine": "sum"},
}


@pytest.mark.parametrize("D,max_lvl", CASES)
def test_remap_state_matches_jax(D, max_lvl):
    """remap_state under the inherit, mean, sum and zero policies gives the
    same value for every cell."""
    spec = {"a": ((), np.float64), "b": ((), np.float64), "c": ((2,), np.float32)}
    rng = np.random.default_rng(7)
    for ref, port, _, _ in _cycle(D, max_lvl):
        pass
    # one more round on the final grids, from a seeded per-cell state
    cells = port.get_cells()
    vals = {"a": rng.normal(size=len(cells)), "b": rng.normal(size=len(cells)),
            "c": rng.normal(size=(len(cells), 2)).astype(np.float32)}
    rs, ps = ref.new_state(spec), port.new_state(spec)
    for k, v in vals.items():
        rs = ref.set_cell_data(rs, k, cells, v)
        ps = port.set_cell_data(ps, k, cells, v)
    lvl = port.mapping.get_refinement_level(cells)
    ops = [("refine_completely_many", cells[lvl < max_lvl][::4]),
           ("unrefine_completely_many", cells[lvl == max_lvl][::2])]
    _apply(ref, ops)
    _apply(port, ops)
    assert len(port.get_removed_cells()) and len(port._last_new_cells)
    rs, ps = ref.remap_state(rs, _POLICIES), port.remap_state(ps, _POLICIES)
    new = port.get_cells()
    np.testing.assert_array_equal(new, ref.get_cells())
    for k in spec:
        np.testing.assert_array_equal(port.get_cell_data(ps, k, new),
                                      np.asarray(ref.get_cell_data(rs, k, new)))


_TABLES = ("nbr_rows", "nbr_valid", "nbr_offset", "nbr_len", "nbr_slot",
           "send_rows", "recv_rows", "pair_counts", "inner_mask", "outer_mask")


@pytest.mark.parametrize("D,max_lvl", CASES)
def test_epoch_matches_full_jax_build(D, max_lvl, monkeypatch):
    """With the JAX package building every epoch in full, the two epochs
    agree table by table, rows included."""
    monkeypatch.setenv("DCCRG_EPOCH_DELTA", "0")
    for ref, port, _, _ in _cycle(D, max_lvl):
        re, pe = ref.epoch, port.epoch
        assert pe.R == re.R
        for name in ("n_local", "n_ghost", "row_of", "cell_len", "cell_level",
                     "cell_ids", "local_mask"):
            np.testing.assert_array_equal(getattr(pe, name), getattr(re, name))
        for d in range(D):
            np.testing.assert_array_equal(pe.ghost_pos[d], re.ghost_pos[d])
        rh, ph = re.hoods[None], pe.hoods[None]
        for name in _TABLES:
            np.testing.assert_array_equal(getattr(ph, name), getattr(rh, name))
        assert (pe.dense is None) == (re.dense is None)


def _rows_by_id(epoch):
    """{(device, cell id): sorted neighbor cell ids (valid entries)} over
    every local row of an epoch."""
    h = epoch.hoods[None]
    out = {}
    for d in range(epoch.n_devices):
        for row in range(int(epoch.n_local[d])):
            nb = h.nbr_rows[d, row][h.nbr_valid[d, row]]
            out[(d, int(epoch.cell_ids[d, row]))] = tuple(
                sorted(epoch.cell_ids[d, nb].tolist()))
    return out


@pytest.mark.parametrize("D,max_lvl", CASES)
def test_epoch_matches_patched_jax_epoch_by_id(D, max_lvl):
    """Against the JAX package's default (incrementally patched) epochs:
    the same cells on the same devices with the same neighbors, and the
    same ghost sets, by cell id."""
    for ref, port, _, _ in _cycle(D, max_lvl):
        re, pe = ref.epoch, port.epoch
        assert _rows_by_id(pe) == _rows_by_id(re)
        for d in range(D):
            np.testing.assert_array_equal(port.remote_cells(d), ref.remote_cells(d))
