"""The member axis of the cohort kernels B2, B3 and B7 (``ops/
dense_advection.py``, ``ops/vlasov_kernel.py``), held through their plain
twins on the CPU: W members stepped in one call, each by its own dt and on
its own slab ring, are bitwise equal to W one-member calls; the wrappers
check the member shapes and the dt arrays.  The kernels themselves run
only on the card (``chip_smoke.py`` phases 2 and 31)."""
import numpy as np
import pytest
import torch

from dccrg_tpu_torch.ops import dense_advection as K
from dccrg_tpu_torch.ops import vlasov_kernel as V
from dccrg_tpu_torch.parallel.dense import HaloExtend


def _dense(W, D, nzl, ny, nx, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    sh = (W, D, nzl, ny, nx)
    rho = t(r.uniform(0.1, 1.0, sh))
    vx, vy, vz = (t(r.normal(0.0, 0.5, sh)) for _ in range(3))
    masks = [t(r.random(n) > 0.2) for n in (nx, ny, D * nzl, D * nzl)]
    dts = t(r.uniform(0.001, 0.01, W))
    return rho, vx, vy, vz, masks, dts


KW = dict(area=(0.1, 0.2, 0.3), inv_vol=7.0)


@pytest.mark.parametrize("W,D,nzl,ny,nx,block", [(3, 2, 8, 6, 5, 4), (4, 1, 4, 8, 8, 2),
                                                 (1, 3, 2, 4, 4, 2)])
def test_blocked_member_axis_equals_member_calls(W, D, nzl, ny, nx, block):
    rho, vx, vy, vz, masks, dts = _dense(W, D, nzl, ny, nx, W * 10 + D)
    ext = HaloExtend(D)
    lo, hi = ext.planes(rho, members=True)
    vlo, vhi = ext.planes(vz, members=True)
    got = K.flux_update_blocked(rho, lo, hi, vx, vy, vz, vlo, vhi, *masks, dts,
                                block=block, **KW)
    for w in range(W):
        l1, h1 = ext.planes(rho[w])
        vl1, vh1 = ext.planes(vz[w])
        want = K.flux_update_blocked(rho[w], l1, h1, vx[w], vy[w], vz[w], vl1, vh1,
                                     *masks, float(dts[w]), block=block, **KW)
        assert torch.equal(got[w], want)


@pytest.mark.parametrize("W,D,nzl", [(3, 3, 5), (2, 1, 7)])
def test_plane_member_axis_equals_member_calls(W, D, nzl):
    rho, vx, vy, vz, masks, dts = _dense(W, D, nzl, 6, 4, 7 * W + D)
    ext = HaloExtend(D)
    got = K.flux_update(ext(rho, members=True), vx, vy, ext(vz, members=True), *masks,
                        dts, **KW)
    for w in range(W):
        want = K.flux_update(ext(rho[w]), vx[w], vy[w], ext(vz[w]), *masks,
                             float(dts[w]), **KW)
        assert torch.equal(got[w], want)


def test_member_planes_stay_on_each_members_ring():
    """HaloExtend's member planes roll over each member's own slots: no
    member reads another's."""
    blk = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).view(2, 3, 2, 1)
    lo, hi = HaloExtend(3).planes(blk, members=True)
    for w in range(2):
        l1, h1 = HaloExtend(3).planes(blk[w])
        assert torch.equal(lo[w], l1) and torch.equal(hi[w], h1)


@pytest.mark.parametrize("W,D,periodic", [(3, 2, (True, False, False)),
                                          (2, 3, (False, True, True)),
                                          (3, 1, (True, True, True))])
@pytest.mark.parametrize("ring", [True, False])
def test_vlasov_member_axis_equals_member_calls(W, D, periodic, ring):
    r = np.random.default_rng(W + 5 * D)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    B = 8
    f = t(r.uniform(0.0, 1.0, (W, D, 4, 5, 6, B)))
    v = t(r.uniform(-1.0, 1.0, (3, B)))
    vx, vy, vz = (v[i].contiguous() for i in range(3))
    dts = t(r.uniform(0.001, 0.01, W))
    kw = dict(block=2, inv_dx=np.array([6.0, 5.0, 4.0 * D]), periodic=periodic)
    if ring:
        got = V.vlasov_step(f, None, None, vx, vy, vz, dts, **kw)
    else:
        lo, hi = V.ring_edges(f, periodic[2])
        got = V.vlasov_step(f, lo, hi, vx, vy, vz, dts, **kw)
    for w in range(W):
        want = V.vlasov_step(f[w], None, None, vx, vy, vz, float(dts[w]), **kw)
        assert torch.equal(got[w], want)


def test_member_scales_are_split_scales():
    """Each member's scales are split_scales' float32 products, bit for
    bit."""
    dts = torch.tensor([0.00123, 0.0456, 1e-7], dtype=torch.float32)
    inv = np.array([32.0, 31.0, 1.0 / 3.0])
    got = V.member_scales(dts, inv, torch.float32)
    for w in range(3):
        want = V.split_scales(float(dts[w]), inv, np.float32)
        assert got[w].tolist() == [float(np.float32(x)) for x in want]


def test_wrappers_check_member_shapes_and_dt():
    rho, vx, vy, vz, masks, dts = _dense(3, 2, 4, 4, 4, 1)
    ext = HaloExtend(2)
    lo, hi = ext.planes(rho, members=True)
    vlo, vhi = ext.planes(vz, members=True)
    args = (rho, lo, hi, vx, vy, vz, vlo, vhi, *masks)
    with pytest.raises(ValueError, match="members need a"):
        K.flux_update_blocked(*args, 0.01, block=2, **KW)
    with pytest.raises(ValueError, match="dt of shape"):
        K.flux_update_blocked(*args, dts[:2], block=2, **KW)
    with pytest.raises(ValueError, match="dt of shape"):
        K.flux_update(ext(rho[0]), vx[0], vy[0], ext(vz[0]), *masks, dts, **KW)
    f = torch.zeros((3, 2, 2, 3, 3, 8))
    v = torch.zeros(8)
    kw = dict(block=2, inv_dx=np.ones(3), periodic=(True,) * 3)
    with pytest.raises(ValueError, match="members need a"):
        V.vlasov_step(f, None, None, v, v, v, 0.1, **kw)
    with pytest.raises(ValueError, match="dt of shape"):
        V.vlasov_step(f, None, None, v, v, v, torch.zeros(2), **kw)
    # the card's dt array: float32 [W] on the fields' device
    with pytest.raises(ValueError, match="float32"):
        K.member_dts(torch.zeros(3, dtype=torch.float64), 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="members need"):
        K.member_dts(0.1, 3, torch.device("cpu"))
    # one scenario's scalar dt: no array, the float32 value (the kernel's
    # scalar instantiation); a member array passes as it is
    assert K.member_dts(0.1, 1, torch.device("cpu")) == (None, float(np.float32(0.1)))
    arr, _ = K.member_dts(torch.ones(3), 3, torch.device("cpu"))
    assert arr.tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="dimensions"):
        K._members(torch.zeros(2, 2), 4)
