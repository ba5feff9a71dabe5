"""The port's halo exchange against the JAX package's ``HaloExchange`` on a
refined grid: after one exchange every ghost row holds its owner's value,
and every (device, cell id) holds the same value in both packages, exactly.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch


def _refined(pkg, D, hood):
    g = (
        pkg.Grid()
        .set_initial_length((6, 6, 6))
        .set_neighborhood_length(hood)
        .set_periodic(True, True, False)
        .set_maximum_refinement_level(2)
        .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=(1 / 6, 1 / 6, 1 / 6))
    )
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    for rad in (0.35, 0.2):
        ids = g.get_cells()
        c = g.geometry.get_center(ids)
        lv = g.mapping.get_refinement_level(ids)
        g.refine_completely_many(
            ids[(np.linalg.norm(c - 0.45, axis=1) < rad) & (lv == lv.max())])
        g.stop_refining()
    return g


SPEC = {"rho": ((), np.float64), "v": ((3,), np.float32), "tag": ((), np.int32)}


def _state(g, rng_seed=3):
    """Seeded per-cell values in the owners' rows; ghost and pad rows hold
    a sentinel the exchange must overwrite (ghosts) or leave (pads)."""
    rng = np.random.default_rng(rng_seed)
    cells = g.get_cells()
    vals = {"rho": rng.normal(size=len(cells)),
            "v": rng.normal(size=(len(cells), 3)).astype(np.float32),
            "tag": rng.integers(0, 1 << 30, len(cells)).astype(np.int32)}
    s = g.new_state(SPEC, fill=-7)
    for k, v in vals.items():
        s = g.set_cell_data(s, k, cells, v)
    return s, vals


def _by_id(g, state):
    """{field: {(device, cell id): value}} over every local and ghost row."""
    ep = g.epoch
    out = {}
    for k, arr in state.items():
        host = np.asarray(arr) if not hasattr(arr, "numpy") else arr.numpy()
        out[k] = {}
        for d in range(ep.n_devices):
            n = int(ep.n_local[d] + ep.n_ghost[d])
            for row in range(n):
                out[k][(d, int(ep.cell_ids[d, row]))] = host[d, row].tobytes()
    return out


@pytest.mark.parametrize("hood", [0, 1])
@pytest.mark.parametrize("D", [3, 8])
def test_exchange_matches_jax(D, hood):
    ref, port = _refined(dccrg_tpu, D, hood), _refined(dccrg_tpu_torch, D, hood)
    np.testing.assert_array_equal(port.get_cells(), ref.get_cells())
    ps, vals = _state(port)
    rs, _ = _state(ref)
    ex = port.halo()
    assert ex.cells_moved == ref.halo().cells_moved > 0
    assert ex.ring_distances == ref.halo().ring_distances
    pout = port.update_copies_of_remote_neighbors(ps)
    rout = ref.update_copies_of_remote_neighbors(rs)
    # every ghost row holds its owner's value
    ep = port.epoch
    pos_of = {int(c): i for i, c in enumerate(port.get_cells())}
    for k in SPEC:
        host = pout[k].numpy()
        for d in range(D):
            rows = np.arange(ep.n_local[d], ep.n_local[d] + ep.n_ghost[d])
            ids = ep.cell_ids[d, rows]
            want = vals[k][[pos_of[int(c)] for c in ids]]
            np.testing.assert_array_equal(host[d, rows], want)
        # owners' rows untouched
        local = ep.local_mask
        np.testing.assert_array_equal(host[local], ps[k].numpy()[local])
    # the same value at every (device, cell id) as the JAX exchange
    assert _by_id(port, pout) == _by_id(ref, rout)


def test_single_slot_exchange_is_identity():
    g = _refined(dccrg_tpu_torch, 1, 1)
    s, _ = _state(g)
    out = g.update_copies_of_remote_neighbors(s)
    assert g.halo().ring_distances == ()
    for k in SPEC:
        assert out[k] is s[k]


def test_cell_datatype_policy_not_ported():
    """The ``cell_datatype`` policy is ported: a policy that selects no cell
    leaves every ghost row as it was, and ships nothing."""
    g = _refined(dccrg_tpu_torch, 3, 0)
    s, _ = _state(g)
    ex = g.halo(cell_datatype=lambda f, ids, *a: np.zeros(len(ids), bool))
    out = ex(s)
    assert ex.bytes_moved(s) == ex.wire_bytes(s) == 0
    for k in SPEC:
        assert out[k] is s[k]
