"""The port's ``utils/verify.py::verify_grid`` against the JAX package's on
the same grid: the port compares neighbour pairs as sorted integer keys and
sums the leaves' volume over distinct edge lengths where the JAX package
builds Python sets and sums cell by cell, so on every grid, intact or
corrupted, both must pass or both raise the same error with the same
message.  The JAX function runs on the port's grid object (pure numpy over
the same attributes)."""
import dataclasses

import numpy as np
import pytest

import dccrg_tpu_torch
from dccrg_tpu.utils.verify import verify_grid as jax_verify_grid
from dccrg_tpu_torch.core.neighbors import LeafSet
from dccrg_tpu_torch.utils.verify import verify_grid


def make_grid(n_dev, max_lvl=2, n=6, hood=1, refine=8, seed=0):
    g = (dccrg_tpu_torch.Grid().set_initial_length((n, n, n))
         .set_neighborhood_length(hood).set_periodic(True, False, True)
         .set_maximum_refinement_level(max_lvl)
         .initialize(n_devices=n_dev, device="cpu"))
    rng = np.random.default_rng(seed)
    if refine:
        for cid in rng.choice(g.get_cells(), size=refine, replace=False):
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def outcome(fn, g):
    """(exception type, message) of ``fn(g)``, or None when it passes."""
    try:
        fn(g)
    except Exception as err:      # noqa: BLE001 - the outcome is compared
        return type(err).__name__, str(err)
    return None


def _hood(g):
    return next(iter(g.epoch.hoods.values()))


def _swap_to_src(g):
    """neighbors_to names a wrong cell for one pair."""
    t = _hood(g).to_src
    t[0] = (t[0] + 1) % len(g.leaves)


def _to_src_past_end(g):
    _hood(g).to_src[-1] = len(g.leaves)


def _to_src_negative(g):
    _hood(g).to_src[len(_hood(g).to_src) // 2] = -1


def _duplicate_to_pair(g):
    """One pair of neighbors_to repeated over another of the same cell:
    the pair sets differ by the overwritten pair."""
    h = _hood(g)
    i = int(np.flatnonzero(np.diff(h.to_start) >= 2)[0])
    a = h.to_start[i]
    h.to_src[a + 1] = h.to_src[a]


def _drop_last_leaf(g):
    """The leaves no longer tile the domain."""
    g.leaves = LeafSet(cells=g.leaves.cells[:-1], owner=g.leaves.owner[:-1])


def _bad_owner(g):
    g.leaves = dataclasses.replace(g.leaves, owner=np.where(
        np.arange(len(g.leaves)) == 3, g.n_devices, g.leaves.owner).astype(np.int32))


def _nbr_past_end(g):
    _hood(g).lists.nbr_pos[0] = len(g.leaves)


CORRUPTIONS = {
    "intact": None,
    "swap_to_src": _swap_to_src,
    "to_src_past_end": _to_src_past_end,
    "to_src_negative": _to_src_negative,
    "duplicate_to_pair": _duplicate_to_pair,
    "drop_last_leaf": _drop_last_leaf,
    "bad_owner": _bad_owner,
    "nbr_past_end": _nbr_past_end,
}


@pytest.mark.parametrize("n_dev", [1, 3])
@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_verify_grid_agrees_with_jax(case, n_dev):
    g = make_grid(n_dev)
    if CORRUPTIONS[case] is not None:
        CORRUPTIONS[case](g)
    want = outcome(jax_verify_grid, g)
    assert (want is None) == (case == "intact"), want
    assert outcome(verify_grid, g) == want


def test_verify_grid_exact_volume_past_63_bits():
    """A 3 x 3 x 1 domain at refinement level 20 spans 1.125 * 2**63 index
    units (an int64 sum would wrap): the volume sum stays exact, so an
    intact grid passes and a missing leaf is caught."""
    g = (dccrg_tpu_torch.Grid().set_initial_length((3, 3, 1))
         .set_neighborhood_length(0).set_maximum_refinement_level(20)
         .initialize(n_devices=2, device="cpu"))
    g.refine_completely(int(g.get_cells()[4]))
    g.stop_refining()
    assert int(np.prod(np.array(g.mapping.length_in_indices, dtype=object))) > 2 ** 63
    assert outcome(verify_grid, g) is None
    assert outcome(jax_verify_grid, g) is None
    _drop_last_leaf(g)
    want = outcome(jax_verify_grid, g)
    assert want is not None and outcome(verify_grid, g) == want


@pytest.mark.parametrize("n_dev", [1, 2])
def test_verify_grid_catches_a_key_that_wraps(n_dev):
    """On 64 leaves a neighbour index raised by 2**58 multiplies to the
    same int64 key as the true one (the product wraps): the range check
    must still name the table, as the JAX package's pair sets do."""
    g = make_grid(n_dev, max_lvl=0, n=4, refine=0)
    assert len(g.leaves) == 64
    _hood(g).to_src[0] += 2 ** 58
    want = outcome(jax_verify_grid, g)
    assert want is not None and outcome(verify_grid, g) == want
