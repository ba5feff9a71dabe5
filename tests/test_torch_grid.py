"""The PyTorch port's Grid and epoch against the JAX package's, exactly."""
import dataclasses

import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection


def _grids(n, nz, hood, periodic, D):
    def build(pkg, **init):
        return (
            pkg.Grid()
            .set_initial_length((n, n, nz))
            .set_neighborhood_length(hood)
            .set_periodic(*periodic)
            .set_geometry(
                pkg.CartesianGeometry,
                start=(0.0, 0.0, 0.0),
                level_0_cell_length=(1.0 / n, 1.0 / n, 1.0 / nz),
            )
            .initialize(**init)
        )

    ref = build(dccrg_tpu, mesh=dccrg_tpu.make_mesh(n_devices=D))
    port = build(dccrg_tpu_torch, n_devices=D, device="cpu")
    return ref, port


@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
@pytest.mark.parametrize("hood", [0, 1])
def test_grid_epoch_matches_jax(hood, periodic, D):
    ref, port = _grids(8, 8, hood, periodic, D)
    assert port.n_devices == ref.n_devices == D
    np.testing.assert_array_equal(port.get_cells(), ref.get_cells())
    re, pe = ref.epoch, port.epoch
    assert dataclasses.asdict(pe.dense) == dataclasses.asdict(re.dense)
    np.testing.assert_array_equal(pe.leaves.owner, re.leaves.owner)
    assert pe.R == re.R
    np.testing.assert_array_equal(pe.n_local, re.n_local)
    np.testing.assert_array_equal(pe.n_ghost, re.n_ghost)
    rh, ph = re.hoods[None], pe.hoods[None]
    np.testing.assert_array_equal(ph.nbr_rows, rh.nbr_rows)
    np.testing.assert_array_equal(ph.nbr_valid, rh.nbr_valid)
    np.testing.assert_array_equal(ph.nbr_offset, rh.nbr_offset)
    np.testing.assert_array_equal(ph.send_rows, rh.send_rows)
    assert tuple(port.shape_signature()) == tuple(ref.shape_signature())


def test_non_slab_grid_is_not_dense():
    """4 z planes over 8 devices: not slab-aligned, in both packages, so
    Advection takes the general gather path in both; one float64 step
    agrees by cell at rtol=1e-12."""
    ref, port = _grids(8, 4, 0, (True, True, True), 8)
    assert ref.epoch.dense is None and port.epoch.dense is None
    np.testing.assert_array_equal(port.epoch.leaves.owner, ref.epoch.leaves.owner)
    np.testing.assert_array_equal(
        port.epoch.hoods[None].nbr_rows, ref.epoch.hoods[None].nbr_rows
    )
    ja = JAdvection(ref, use_pallas=False)
    pa = dccrg_tpu_torch.Advection(port)
    assert pa.dense is None and pa._flat_kind is None
    js, ps = ja.initialize_state(), pa.initialize_state()
    dt = 0.3 * ja.max_time_step(js)
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    js, ps = ja.step(js, dt), pa.step(ps, dt)
    cells = port.get_cells()
    np.testing.assert_allclose(
        pa.get_cell_data(ps, "density", cells),
        np.asarray(ja.get_cell_data(js, "density", cells)), rtol=1e-12,
    )


def test_new_state_layout():
    _, port = _grids(8, 8, 0, (True, True, True), 4)
    state = port.new_state({"a": ((), np.float32), "b": ((3,), np.float64)})
    assert state["a"].shape == (4, port.epoch.R) and state["a"].dtype == torch.float32
    assert state["b"].shape == (4, port.epoch.R, 3) and state["b"].dtype == torch.float64
    assert state["a"].device.type == "cpu" and not state["a"].any()


def test_initialize_defaults_to_cuda():
    """No device means CUDA; without one, initialize raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dccrg_tpu_torch.Grid().set_initial_length((4, 4, 4)).initialize()
