"""Each CUDA kernel's plain twin (the port's CPU path) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance rtol=2e-7, atol=1e-9: the JAX package's own for its kernels in
interpret mode (tests/test_advection_dense.py), where XLA-CPU contracts
multiply-adds differently from one path to another.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dccrg_tpu.ops import dense_advection as jops
from dccrg_tpu_torch.ops import dense_advection as tops

RTOL, ATOL = 2e-7, 1e-9


def _inputs(D, nzl, ny, nx, periodic, seed=0):
    """Density, velocities (both signs, so both upwind branches run), the
    step's constants and the face masks, all float32 numpy."""
    rng = np.random.default_rng(seed)
    shape = (D, nzl, ny, nx)
    rho = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    vx, vy = (rng.normal(0.0, 0.5, shape).astype(np.float32) for _ in range(2))
    z = (np.arange(D * nzl) + 0.5) / (D * nzl)
    vz = np.broadcast_to(
        (0.3 * np.sin(2 * np.pi * z)).reshape(D, nzl, 1, 1), shape
    ).astype(np.float32) + rng.normal(0.0, 0.05, shape).astype(np.float32)
    l0 = np.array([1.0 / nx, 1.0 / ny, 1.0 / (D * nzl)])
    area = tuple(float(a) for a in np.array(
        [l0[1] * l0[2], l0[0] * l0[2], l0[0] * l0[1]]).astype(np.float32))
    inv_vol = 1.0 / float(l0.prod())
    mx, my = np.ones(nx, np.float32), np.ones(ny, np.float32)
    mzu = np.ones((D, nzl), np.float32)
    if not periodic[0]:
        mx[-1] = 0.0
    if not periodic[1]:
        my[-1] = 0.0
    if not periodic[2]:
        mzu[-1, -1] = 0.0
    mzd = np.roll(mzu.reshape(-1), 1).reshape(D, nzl)
    return dict(rho=rho, vx=vx, vy=vy, vz=vz, mx=mx, my=my, mzu=mzu, mzd=mzd,
                area=area, inv_vol=inv_vol, dt=np.float32(0.002))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(a):
    """Ring-received planes (below, above) of each device block."""
    return np.roll(a[:, -1:], 1, axis=0), np.roll(a[:, :1], -1, axis=0)


PERIODIC = [(True, True, True), (True, True, False), (False, False, False)]


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("steps", [4, 7])
def test_fused_run_twin_matches_pallas(steps, periodic):
    n, nz = 8, 8
    x = _inputs(1, nz, n, n, periodic)
    run = jops.make_fused_run(nz, n, n, x["area"], x["inv_vol"], interpret=True)
    ref = run(
        x["rho"][0], x["vx"][0], x["vy"][0], x["vz"][0],
        jnp.asarray(x["mx"]).reshape(1, 1, n), jnp.asarray(x["my"]).reshape(1, n, 1),
        jnp.asarray(x["mzu"][0]).reshape(nz, 1, 1),
        jnp.asarray(x["mzd"][0]).reshape(nz, 1, 1), x["dt"], steps,
    )
    calls = tops.PLAIN_CALLS["fused_run"]
    got = tops.fused_run(
        _t(x["rho"][0]), _t(x["vx"][0]), _t(x["vy"][0]), _t(x["vz"][0]),
        _t(x["mx"]), _t(x["my"]), _t(x["mzu"][0]), _t(x["mzd"][0]),
        x["dt"], steps, area=x["area"], inv_vol=x["inv_vol"],
    )
    assert tops.PLAIN_CALLS["fused_run"] == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("periodic", PERIODIC)
@pytest.mark.parametrize("nz,D", [(32, 1), (32, 4)])
def test_blocked_twin_matches_pallas(nz, D, periodic):
    n, nzl = 8, nz // D
    block = tops.pick_step_block(nzl, n, n)
    assert block == jops.pick_step_block(nzl, n, n) >= 2
    x = _inputs(D, nzl, n, n, periodic)
    upd = jops.make_flux_update_blocked_direct(
        nzl, n, n, block, x["area"], x["inv_vol"], interpret=True)
    r_lo, r_hi = _edges(x["rho"])
    v_lo, v_hi = _edges(x["vz"])
    ref = np.stack([
        np.asarray(upd(
            x["rho"][d], r_lo[d], r_hi[d], x["vx"][d], x["vy"][d], x["vz"][d],
            v_lo[d], v_hi[d], jnp.asarray(x["mx"]).reshape(1, 1, n),
            jnp.asarray(x["my"]).reshape(1, n, 1),
            jnp.asarray(x["mzu"][d]).reshape(nzl, 1, 1),
            jnp.asarray(x["mzd"][d]).reshape(nzl, 1, 1), x["dt"],
        ))
        for d in range(D)
    ])
    got = tops.flux_update_blocked(
        _t(x["rho"]), _t(r_lo), _t(r_hi), _t(x["vx"]), _t(x["vy"]), _t(x["vz"]),
        _t(v_lo), _t(v_hi), _t(x["mx"]), _t(x["my"]), _t(x["mzu"]),
        _t(x["mzd"]), x["dt"], block=block, area=x["area"], inv_vol=x["inv_vol"],
    )
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("periodic", PERIODIC)
def test_plane_twin_matches_pallas(periodic):
    n, nz = 8, 7
    assert tops.pick_step_block(nz, n, n) == 0
    x = _inputs(1, nz, n, n, periodic)
    upd = jops.make_flux_update(nz, n, n, x["area"], x["inv_vol"], interpret=True)
    ext = lambda a: np.concatenate([_edges(a)[0], a, _edges(a)[1]], axis=1)
    rho_e, vz_e = ext(x["rho"]), ext(x["vz"])
    ref = upd(
        rho_e[0], x["vx"][0], x["vy"][0], vz_e[0],
        jnp.asarray(x["mx"]).reshape(1, 1, n), jnp.asarray(x["my"]).reshape(1, n, 1),
        jnp.asarray(x["mzu"][0]).reshape(nz, 1, 1),
        jnp.asarray(x["mzd"][0]).reshape(nz, 1, 1), x["dt"],
    )
    got = tops.flux_update(
        _t(rho_e), _t(x["vx"]), _t(x["vy"]), _t(vz_e), _t(x["mx"]), _t(x["my"]),
        _t(x["mzu"]), _t(x["mzd"]), x["dt"], area=x["area"], inv_vol=x["inv_vol"],
    )
    np.testing.assert_allclose(got.numpy()[0], np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(8, 8, 8), (64, 128, 128), (128, 512, 512), (63, 128, 128)])
def test_dispatch_thresholds_match_jax(shape):
    """The copied thresholds pick the same kernel as the JAX package."""
    nzl, ny, nx = shape
    assert tops.fused_run_fits(nzl, ny, nx) == jops.fused_run_fits(nzl, ny, nx)
    assert tops.pick_step_block(nzl, ny, nx) == jops.pick_step_block(nzl, ny, nx)
    assert tops.flux_update_fits(ny, nx) == jops.flux_update_fits(ny, nx)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers compute with the twins and count no
    kernel launch; a CPU/CUDA mix is refused."""
    tops.reset_counts()
    x = _inputs(1, 8, 8, 8, (True, True, True))
    r_lo, r_hi = _edges(x["rho"])
    tops.flux_update_blocked(
        _t(x["rho"]), _t(r_lo), _t(r_hi), _t(x["vx"]), _t(x["vy"]), _t(x["vz"]),
        _t(r_lo), _t(r_hi), _t(x["mx"]), _t(x["my"]), _t(x["mzu"]),
        _t(x["mzd"]), x["dt"], block=8, area=x["area"], inv_vol=x["inv_vol"],
    )
    assert tops.LAUNCHES == {k: 0 for k in tops.LAUNCHES}
    assert tops.PLAIN_CALLS["flux_update_blocked"] == 1
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tops.fused_run(_t(x["rho"][0]), _t(x["vx"][0]), _t(x["vy"][0]),
                       _t(x["vz"][0]), meta, _t(x["my"]), _t(x["mzu"][0]),
                       _t(x["mzd"][0]), x["dt"], 1, area=x["area"],
                       inv_vol=x["inv_vol"])
