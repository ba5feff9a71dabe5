"""The port's incremental epoch rebuild (``parallel/epoch_delta.py``) against
its oracle and the JAX package (tests/test_epoch_delta.py mirrored): after
every AMR commit and repartition of a seeded churn sequence, the live
(delta-patched) epoch equals a fresh ``build_epoch`` of the same snapshot
table by table, and equals the JAX package's epoch after the same
sequence, at 1 and 8 slots, with a user neighborhood registered midway, on
the native and the numpy paths.  The fast path engages, and every
documented fallback is reached.  All comparisons exact
(``compare_epochs``)."""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu_torch.parallel import epoch_delta
from dccrg_tpu_torch.parallel.epoch import build_epoch
from dccrg_tpu_torch.obs import metrics
from dccrg_tpu_torch.parallel.epoch_delta import (
    FALLBACK_REASONS,
    build_epoch_delta,
)
from dccrg_tpu_torch.parallel.shapes import epoch_shape_hints
from dccrg_tpu_torch.utils.verify import compare_epochs, verify_grid


def count(name, **labels):
    """A counter of the port's registry (``epoch.delta_*``)."""
    return metrics.counter_value(name, **labels)


def make_grid(pkg, n=8, max_lvl=2, n_dev=8, method="RCB", hood=1,
              periodic=(True, False, True)):
    g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(hood)
         .set_periodic(*periodic).set_maximum_refinement_level(max_lvl)
         .set_load_balancing_method(method)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev))
    return g.initialize(n_devices=n_dev, device="cpu")


def oracle(g):
    """A fresh full build with the live epoch's shapes as hints (the bucket
    choice is idempotent against its own result)."""
    return build_epoch(g.mapping, g.topology, g.leaves, g.n_devices,
                       g.neighborhoods, uniform_geometry=g._uniform_geometry(),
                       shape_hints=epoch_shape_hints(g.epoch))


def churn_step(g, rng, round_i):
    """tests/test_epoch_delta.py::churn_step: an AMR request storm and a
    commit, then every other round a repartition with shuffled pins."""
    ids = g.get_cells()
    for cid in rng.choice(ids, size=min(10, len(ids)), replace=False):
        op = rng.integers(4)
        (g.refine_completely, g.unrefine_completely, g.dont_refine,
         g.dont_unrefine)[op](int(cid))
    before = set(g.get_cells().tolist())
    g.stop_refining()
    after = set(g.get_cells().tolist())
    delta = g.get_last_adaptation_delta()
    assert set(delta.added.tolist()) == after - before
    assert set(delta.removed.tolist()) == before - after
    yield "amr"
    if round_i % 2 == 1:
        for cid in rng.choice(g.get_cells(), size=5, replace=False):
            g.pin(int(cid), int(rng.integers(g.n_devices)))
        g.balance_load()
        g.unpin_all_cells()
        yield "lb"


def _run_churn(n_dev, seed, rounds, hood_at=None, check=None):
    """The same churn on both packages in lockstep; ``check(jg, tg)`` after
    every mutation."""
    grids = [make_grid(pkg, n_dev=n_dev) for pkg in (dccrg_tpu, dccrg_tpu_torch)]
    rngs = [np.random.default_rng(seed) for _ in grids]
    for round_i in range(rounds):
        if round_i == hood_at:
            for g in grids:
                assert g.add_neighborhood(7, [(1, 0, 0), (0, -1, 0)])
        for _ in zip(*(churn_step(g, r, round_i) for g, r in zip(grids, rngs))):
            check(*grids)
    return grids


def _check_both(jg, tg):
    np.testing.assert_array_equal(tg.leaves.cells, jg.leaves.cells)
    compare_epochs(tg.epoch, oracle(tg))
    compare_epochs(tg.epoch, jg.epoch)
    verify_grid(tg)


@pytest.mark.parametrize("n_dev,seed", [(1, 0), (8, 1), (8, 5)])
def test_churn_identical_to_full_build_and_jax(n_dev, seed):
    amr, lb = count("epoch.delta_builds", kind="amr"), count("epoch.delta_builds", kind="lb")
    _run_churn(n_dev, seed, 6, hood_at=3, check=_check_both)
    assert count("epoch.delta_builds", kind="amr") > amr
    # one slot: every partition is the current one, nothing to patch
    assert (count("epoch.delta_builds", kind="lb") > lb) == (n_dev > 1)


def test_numpy_path_identical_to_full_build(monkeypatch):
    """The pure-numpy delta against the pure-numpy full build (every
    native helper disabled)."""
    import dccrg_tpu_torch.native as native

    for name, ret in (("native_find_neighbors", None), ("native_invert_and_pairs", None),
                      ("native_sort_unique_u64", None), ("native_fill_tables", False),
                      ("native_delta_patch_tables", False)):
        monkeypatch.setattr(native, name, lambda *a, _r=ret, **k: _r)
    rng = np.random.default_rng(2)
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    for round_i in range(4):
        for _ in churn_step(g, rng, round_i):
            compare_epochs(g.epoch, oracle(g))
            verify_grid(g)


def test_delta_fast_path_engages():
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
    g.stop_refining()
    before, reuse = count("epoch.delta_builds"), count("epoch.table_pool_reuse")
    for i in range(2):
        g.refine_completely(int(g.get_cells()[i]))
        g.stop_refining()
    assert count("epoch.delta_builds") == before + 2
    # the second patch reuses the first one's retired tables
    assert count("epoch.table_pool_reuse") > reuse
    compare_epochs(g.epoch, oracle(g))


def test_fallback_fraction_and_dense_flip():
    g = make_grid(dccrg_tpu_torch, n_dev=8, max_lvl=1)
    assert g.epoch.dense is not None
    flips = count("epoch.delta_fallbacks", reason="dense_flip")
    g.refine_completely(1)
    g.stop_refining()
    assert count("epoch.delta_fallbacks", reason="dense_flip") > flips and g.epoch.dense is None
    compare_epochs(g.epoch, oracle(g))
    frac = count("epoch.delta_fallbacks", reason="fraction")
    g.refine_completely_many(g.get_cells())
    g.stop_refining()
    assert count("epoch.delta_fallbacks", reason="fraction") > frac
    compare_epochs(g.epoch, oracle(g))


def test_fallback_r_growth(monkeypatch):
    monkeypatch.setenv("DCCRG_EPOCH_DELTA_MAX_R_GROWTH", "1.0")
    monkeypatch.setenv("DCCRG_EPOCH_BUCKETS", "0")
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    g.refine_completely(1)
    g.stop_refining()
    before = count("epoch.delta_fallbacks", reason="r_growth")
    g.refine_completely(int(g.get_cells()[10]))
    g.stop_refining()
    assert count("epoch.delta_fallbacks", reason="r_growth") > before
    compare_epochs(g.epoch, oracle(g))


def test_fallback_device_count_and_hoods_changed():
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    g.refine_completely(1)
    g.stop_refining()
    before = count("epoch.delta_fallbacks", reason="device_count")
    assert build_epoch_delta(g.epoch, g.leaves, g.n_devices + 1, g.neighborhoods,
                             uniform_geometry=g._uniform_geometry()) is None
    assert count("epoch.delta_fallbacks", reason="device_count") > before
    before = count("epoch.delta_fallbacks", reason="hoods_changed")
    hoods = {**g.neighborhoods, 3: np.array([[1, 0, 0]], dtype=np.int64)}
    assert build_epoch_delta(g.epoch, g.leaves, g.n_devices, hoods,
                             uniform_geometry=g._uniform_geometry()) is None
    assert count("epoch.delta_fallbacks", reason="hoods_changed") > before
    assert set(FALLBACK_REASONS) == {"fraction", "r_growth", "dense_flip",
                                     "device_count", "hoods_changed"}


def test_delta_disabled_by_env(monkeypatch):
    """DCCRG_EPOCH_DELTA=0: no patch; the commit rebuilds in full and the
    epoch still equals the JAX package's under the same switch."""
    monkeypatch.setenv("DCCRG_EPOCH_DELTA", "0")
    before = count("epoch.delta_builds")
    jg, tg = (make_grid(pkg, n_dev=1) for pkg in (dccrg_tpu, dccrg_tpu_torch))
    for g in (jg, tg):
        g.refine_completely(1)
        g.stop_refining()
    assert build_epoch_delta(tg.epoch, tg.leaves, tg.n_devices, tg.neighborhoods,
                             uniform_geometry=tg._uniform_geometry()) is None
    assert count("epoch.delta_builds") == before and not epoch_delta.delta_enabled()
    compare_epochs(tg.epoch, oracle(tg))
    compare_epochs(tg.epoch, jg.epoch)


def test_epoch_verify_env_cross_checks(monkeypatch):
    """DCCRG_EPOCH_VERIFY=1: every patched epoch checks itself against a
    fresh full build, and verify_grid checks the live one again."""
    monkeypatch.setenv("DCCRG_EPOCH_VERIFY", "1")
    rng = np.random.default_rng(3)
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    for round_i in range(3):
        for _ in churn_step(g, rng, round_i):
            verify_grid(g)


def test_prev_epoch_is_slim_and_releasable():
    g = make_grid(dccrg_tpu_torch, n_dev=8)
    s1 = g.new_state({"a": ((), np.float64)}, fill=1.0)
    s2 = g.new_state({"b": ((), np.float32)}, fill=2.0)
    g.refine_completely(1)
    g.stop_refining()
    carry = g._prev_epoch
    assert carry is not None and not hasattr(carry, "hoods")
    assert not hasattr(carry, "cell_ids")
    s1, s2 = g.remap_state(s1), g.remap_state(s2)
    ids = g.get_cells()
    assert np.allclose(g.get_cell_data(s1, "a", ids), 1.0)
    assert np.allclose(g.get_cell_data(s2, "b", ids), 2.0)
    g.release_prev_epoch()
    assert g._prev_epoch is None and g.remap_state(s1) is s1
