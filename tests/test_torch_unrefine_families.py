"""Unrefine queues that hold several siblings of one family commit one
parent a family (``amr/refinement.py::one_per_family``).

The union of several controllers' queues (``utils.collectives.
sync_adaptation``), a caller's ``unrefine_completely_many`` or a queue set
directly can hold more than one sibling of a family; one process's
``unrefine_completely`` queues one.  Here the union is set directly, the
way ``tests/test_torch_collectives.py`` fakes the seam: the leaves, owners
and ``remap_state``'s "mean" / "sum" parents must be bitwise equal to a
grid that queued one sibling a family, and to the JAX package's grid with
one sibling queued.  The leaf-set check raises ``ValueError`` even under
``python -O``."""
import subprocess
import sys

import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu_torch.amr.refinement import one_per_family
from dccrg_tpu_torch.core.neighbors import LeafSet

#: cells refined first, on a 4x4x2 grid of maximum level 1
REFINED = (6, 11)


def _grid(pkg, D):
    g = (pkg.Grid().set_initial_length((4, 4, 2)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1).set_load_balancing_method("RCB"))
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    for c in REFINED:
        assert g.refine_completely(c)
    g.stop_refining()
    return g


def _commit(pkg, D, queue):
    """``queue(grid, children)`` fills the unrefine queue; returns the
    leaves, owners and the remapped fields by cell id."""
    g = _grid(pkg, D)
    cells = g.get_cells()
    st = g.new_state({"rho": ((), np.float64), "q": ((), np.float64)})
    st = g.set_cell_data(st, "rho", cells, np.sin(cells.astype(np.float64)))
    st = g.set_cell_data(st, "q", cells, np.cos(3.0 * cells.astype(np.float64)))
    kids = g.mapping.get_all_children(np.asarray(REFINED, np.uint64))
    queue(g, kids)
    g.stop_refining()
    st = g.remap_state(st, policy={"rho": {"unrefine": "mean"},
                                   "q": {"unrefine": "sum"}})
    ids = g.get_cells()
    return (ids, np.asarray(g.leaves.owner, np.int64),
            np.asarray(g.get_cell_data(st, "rho", ids)),
            np.asarray(g.get_cell_data(st, "q", ids)))


def _one_sibling(g, kids):
    for fam in kids:
        assert g.unrefine_completely(int(fam[0]))


#: child positions queued a family: different siblings, repeats, a whole
#: family
UNIONS = {"two_siblings": [(0, 5), (2, 7)], "three_and_one": [(1, 3, 6), (4,)],
          "whole_family": [tuple(range(8)), (0, 7)]}


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("union", sorted(UNIONS))
def test_union_queue_commits_one_parent(union, D):
    def set_union(g, kids):
        g.amr.to_unrefine = {int(fam[i]) for fam, pos in zip(kids, UNIONS[union])
                             for i in pos}

    got = _commit(dccrg_tpu_torch, D, set_union)
    one = _commit(dccrg_tpu_torch, D, _one_sibling)
    ref = _commit(dccrg_tpu, D, _one_sibling)
    assert len(got[0]) == 32
    for a, b, c in zip(got, one, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("D", [1, 4])
def test_unrefine_completely_many_siblings(D):
    def many(g, kids):
        g.unrefine_completely_many(np.concatenate([kids[0][[0, 3, 5]], kids[1][[2]]]))

    got = _commit(dccrg_tpu_torch, D, many)
    for a, b in zip(got, _commit(dccrg_tpu, D, _one_sibling)):
        np.testing.assert_array_equal(a, b)


def test_one_per_family_keeps_the_smallest_id():
    g = _grid(dccrg_tpu_torch, 1)
    kids = g.mapping.get_all_children(np.asarray(REFINED, np.uint64))
    queue = {int(kids[0][5]), int(kids[0][2]), int(kids[1][7]), int(kids[1][1])}
    got = one_per_family(g.mapping, queue)
    assert got.tolist() == sorted([int(kids[0][2]), int(kids[1][1])])


def test_leaf_set_rejects_repeats():
    with pytest.raises(ValueError, match="sorted unique"):
        LeafSet(cells=np.asarray([1, 2, 2], np.uint64), owner=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="sorted unique"):
        LeafSet(cells=np.asarray([3, 1], np.uint64), owner=np.zeros(2, np.int32))


def test_leaf_set_check_survives_python_O():
    code = ("import numpy as np\n"
            "from dccrg_tpu_torch.core.neighbors import LeafSet\n"
            "try:\n"
            "    LeafSet(cells=np.asarray([1, 2, 2], np.uint64), owner=np.zeros(3, np.int32))\n"
            "except ValueError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-O", "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert "raised cells must be sorted unique" in out.stdout
