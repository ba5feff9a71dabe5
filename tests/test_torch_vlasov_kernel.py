"""The Vlasov step kernel's plain twin (the port's CPU path) against the JAX
package's Pallas kernel in interpret mode, one step on the same numpy
inputs, every slab slot of a multi-device layout in one call.

Tolerance: 4 ULP of the larger magnitude, elementwise — the JAX package's
own envelope for this kernel (tests/test_vlasov.py:309-328).  The twin
rounds every operation on its own, as the CUDA kernel does; XLA-CPU may
contract ``f - s * (flux_hi - flux_lo)`` into a multiply-add, which moves
the last bits and nothing else.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dccrg_tpu.ops.vlasov_kernel import make_vlasov_step_blocked
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
from dccrg_tpu_torch.ops import vlasov_kernel as tvk

N, NV = 8, 4
B = NV**3


def assert_within_4ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    bad = np.abs(got - want) > 4 * ulp
    assert not bad.any(), (
        f"{int(bad.sum())} elements beyond 4 ULP; max diff {np.abs(got - want).max()}")


def _bins():
    c = (np.arange(NV) + 0.5) / NV * 2 - 1
    vz, vy, vx = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([vx.ravel(), vy.ravel(), vz.ravel()]).astype(np.float32)  # [3, B]


def _inputs(D, nz, periodic, seed=0):
    """Seeded phase space ``[D, nzl, N, N, B]``, the ring's edge planes
    (vacuum at an open z boundary), bin velocities and the step's dt."""
    rng = np.random.default_rng(seed)
    nzl = nz // D
    f = rng.uniform(0.0, 1.0, (D, nzl, N, N, B)).astype(np.float32)
    lo, hi = np.roll(f[:, -1:], 1, axis=0), np.roll(f[:, :1], -1, axis=0)
    if not periodic[2]:
        lo[0] = 0.0
        hi[-1] = 0.0
    inv_dx = np.array([N, N, nz], np.float64)
    dt = float(np.float32(0.4 / (nz * 0.75)))
    return f, lo, hi, _bins(), inv_dx, dt


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False),
                                      (False, False, False)],
                         ids=["periodic", "part_open", "open"])
@pytest.mark.parametrize("D,nz", [(1, 8), (2, 8), (2, 32)])
def test_vlasov_twin_matches_pallas(D, nz, periodic):
    nzl = nz // D
    block = tvk.pick_vlasov_block(nzl, N, N, B)
    assert block >= 2
    if nz == 32:
        assert nzl > block, "must exercise the m > 1 path"
    f, lo, hi, v, inv_dx, dt = _inputs(D, nz, periodic)
    step = make_vlasov_step_blocked(nzl, N, N, B, inv_dx, periodic, block=block,
                                    interpret=True)
    vj = [jnp.asarray(v[d]).reshape(1, 1, 1, B) for d in range(3)]
    want = np.stack([np.asarray(step(f[d], lo[d], hi[d], *vj, dt)) for d in range(D)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    calls = PLAIN_CALLS["vlasov_step"]
    got = tvk.vlasov_step(t(f), t(lo), t(hi), t(v[0]), t(v[1]), t(v[2]), dt,
                          block=block, inv_dx=inv_dx, periodic=periodic)
    assert PLAIN_CALLS["vlasov_step"] == calls + 1
    assert_within_4ulp(got.numpy(), want)


def test_vlasov_twin_block_independent():
    """The z-block height picks the kernel's tiling, never the values."""
    f, lo, hi, v, inv_dx, dt = _inputs(2, 32, (True, False, True), seed=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(f), t(lo), t(hi), t(v[0]), t(v[1]), t(v[2]), dt)
    kw = dict(inv_dx=inv_dx, periodic=(True, False, True))
    a = tvk.vlasov_step_blocked_plain(*args, block=2, **kw)
    b = tvk.vlasov_step_blocked_plain(*args, block=8, **kw)
    assert torch.equal(a, b)


def test_vlasov_cpu_wrapper_launches_nothing():
    reset_counts()
    f, lo, hi, v, inv_dx, dt = _inputs(1, 8, (True, True, True))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tvk.vlasov_step(t(f), t(lo), t(hi), t(v[0]), t(v[1]), t(v[2]), dt, block=4,
                    inv_dx=inv_dx, periodic=(True, True, True))
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    assert PLAIN_CALLS["vlasov_step"] == 1
