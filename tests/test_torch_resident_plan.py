"""Launch plans of the on-chip whole-run kernels B1 (``fused_run``) and B4
(``gol_run``), and the identities their designs rest on.

The plans are pure Python: the wrapper passes the plan it computes to the
kernel, so the plan tested here is the plan that runs on the card.  Checked:
the tiles cover every cell exactly once, a CTA's shared memory fits an
H100's 227 KB and the CTAs its 132 SMs, at the main-path shapes, at every
block or board the dispatch thresholds admit (swept), and at degenerate
extents; where nothing fits, the plan refuses.  The plans take the card's
limits as arguments; here they are an H100's.  The constants a plan shares
with its kernel are pinned to the CUDA sources.

The identities are exact (bitwise): B1 hoists one z product a cell and
applies the z+ and z- masks at use; B4 recomputes a k-deep halo of wrapped
cells for k turns.  Both are checked here on the twins' arithmetic in
torch, tile by tile, against the twins.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from dccrg_tpu_torch.ops import dense_advection as K
from dccrg_tpu_torch.ops import gol_kernel as G
from dccrg_tpu_torch.ops import resident as R

#: an H100 SXM's SM count and the shared memory one block may opt into
SMS, SMEM = 132, 227 * 1024
CSRC = pathlib.Path(K.__file__).resolve().parents[1] / "csrc"


def _cover(extents, parts):
    """Count of tiles covering each cell, from the kernels' part rule."""
    hits = np.zeros(extents, dtype=np.int32)
    spans = [[R.part(n, p, i) for i in range(p)] for n, p in zip(extents, parts)]
    for idx in np.ndindex(*parts):
        sl = tuple(slice(s, s + n) for s, n in
                   (spans[a][i] for a, i in enumerate(idx)))
        assert all(n >= 1 for _, n in (spans[a][i] for a, i in enumerate(idx)))
        hits[sl] += 1
    return hits


def _largest_tile(extents, parts):
    return tuple(max(R.part(n, p, i)[1] for i in range(p))
                 for n, p in zip(extents, parts))


def _check_fused(shape, plan):
    assert np.all(_cover(shape, plan.parts) == 1)
    assert plan.ctas == int(np.prod(plan.parts)) <= SMS
    assert plan.tile == _largest_tile(shape, plan.parts)
    split = tuple(p > 1 for p in plan.parts)
    assert plan.smem_bytes == K.fused_smem_bytes(plan.tile, split) <= SMEM
    bx, by = plan.threads
    assert 1 <= bx <= plan.tile[2] and by <= plan.tile[1] and bx * by <= R.RUN_THREADS
    tz, ty, tx = plan.tile
    assert plan.face_floats >= max(tz * ty, tz * tx, ty * tx)
    assert K.fused_halo_cells(plan.tile, split) <= K.HALO_SLOTS * bx * by


FUSED_SHAPES = [
    (64, 128, 128),    # headline
    (67, 128, 128),    # largest block fused_run_fits admits at 128 x 128
    (9, 17, 33),       # extents no brick divides
    (1, 1, 1), (2, 2, 2), (1, 128, 128), (2, 128, 128), (64, 1, 128),
    (64, 2, 128), (64, 128, 1), (64, 128, 2),
    (1, 1, 1110255), (1110255, 1, 1), (1, 1024, 1084),
]


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_plan_tiles_and_fits(shape):
    assert K.fused_run_fits(*shape)
    _check_fused(shape, K.fused_run_plan(*shape, SMS, SMEM))


def test_fused_plan_headline_uses_the_card():
    plan = K.fused_run_plan(64, 128, 128, SMS, SMEM)
    assert plan.ctas >= 120 and plan.threads[0] * plan.threads[1] >= 512


@pytest.mark.parametrize("vals", [
    (1, 2, 3, 5, 8, 16, 31, 33, 64, 127, 128, 129),
    (200, 256, 333, 512, 1000, 1024, 2048, 4096, 10007, 65536, 1110255),
], ids=["small", "large"])
def test_fused_plan_fits_every_admitted_block(vals):
    """For (ny, nx) over the list, the deepest block the dispatch admits
    (and so every shallower one) has a plan that fits."""
    nmax = 72 * 2 ** 20 // 68
    for ny in vals:
        for nx in vals:
            if ny * nx > nmax:
                continue
            nzl = nmax // (ny * nx)
            assert K.fused_run_fits(nzl, ny, nx) and not K.fused_run_fits(nzl + 1, ny, nx)
            plan = K.fused_run_plan(nzl, ny, nx, SMS, SMEM)
            assert plan.smem_bytes <= SMEM and plan.ctas <= SMS
            assert plan.tile == _largest_tile((nzl, ny, nx), plan.parts)


@pytest.mark.parametrize("args", [(64, 128, 128, 132, 150_000),
                                  (64, 128, 128, 1, SMEM), (1, 1, 1, 1, 16)])
def test_fused_plan_refuses_what_does_not_fit(args):
    with pytest.raises(ValueError, match="no cut of the .* fits"):
        K.fused_run_plan(*args)


def _check_gol(shape, plan):
    assert np.all(_cover(shape, plan.parts) == 1)
    assert plan.ctas == int(np.prod(plan.parts)) <= SMS
    assert plan.tile == _largest_tile(shape, plan.parts)
    k = plan.turns_per_round
    split = tuple(p > 1 for p in plan.parts)
    assert plan.smem_bytes == G.gol_smem_bytes(plan.tile, split, k) <= SMEM
    for n, p in zip(shape, plan.parts):
        assert p == 1 or n // p >= k   # a halo reaches the adjacent tiles only
    h = plan.tile[0] + 2 * k * split[0]
    w = plan.tile[1] + 2 * k * split[1]
    bx, by = plan.threads
    assert 1 <= bx <= w and 1 <= by <= h and bx * by <= R.RUN_THREADS
    assert G.gol_halo_cells(plan.tile, split, k) <= G.GOL_HALO_SLOTS * bx * by


GOL_SHAPES = [(500, 500), (1773, 1774), (1, 500), (500, 1), (5, 7), (1, 1),
              (2, 2), (3145728, 1), (1, 3145728), (1024, 3072)]


@pytest.mark.parametrize("shape", GOL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gol_plan_tiles_and_fits(shape):
    assert G.gol_run_fits(*shape)
    plan = G.gol_run_plan(*shape, SMS, SMEM)
    _check_gol(shape, plan)
    assert 1 <= plan.turns_per_round <= G.GOL_TURNS_PER_ROUND
    if shape == (500, 500):
        assert plan.turns_per_round == G.GOL_TURNS_PER_ROUND


def test_gol_plan_small_boards_run_in_one_tile():
    plan = G.gol_run_plan(5, 7, SMS, SMEM)
    assert plan.parts == (1, 1) and plan.ctas == 1


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 8, 12, 16])
def test_gol_plan_turns_per_round(k):
    plan, _ = G._gol_plan_at(500, 500, SMS, SMEM, k)
    _check_gol((500, 500), plan)
    assert plan.turns_per_round == k and plan.ctas >= 120


def test_gol_plan_fits_every_admitted_board():
    nmax = 3 * 2 ** 20
    for ny in (1, 2, 3, 5, 8, 16, 31, 64, 100, 128, 333, 500, 1000, 1773, 4096, 65536):
        nx = nmax // ny
        assert G.gol_run_fits(ny, nx) and not G.gol_run_fits(ny, nx + 1)
        for shape in ((ny, nx), (nx, ny)):
            plan = G.gol_run_plan(*shape, SMS, SMEM)
            assert plan.smem_bytes <= SMEM and plan.ctas <= SMS
            assert plan.tile == _largest_tile(shape, plan.parts)


@pytest.mark.parametrize("smem", [25_000, 20_000, 17_000])
def test_gol_plan_lowers_k_before_it_refuses(smem):
    """Where k = GOL_TURNS_PER_ROUND does not fit, the plan takes the
    largest smaller k that does; where not even k = 1 fits, it refuses."""
    plan = G.gol_run_plan(500, 500, SMS, smem)
    _check_gol((500, 500), plan)
    assert plan.turns_per_round < G.GOL_TURNS_PER_ROUND and plan.smem_bytes <= smem
    bigger, _ = G._gol_plan_at(500, 500, SMS, smem, plan.turns_per_round + 1)
    assert bigger is None
    with pytest.raises(ValueError, match="no cut of the .* fits"):
        G.gol_run_plan(500, 500, SMS, 16_000)   # k = 1 needs 16,896 bytes


@pytest.mark.parametrize("value,source,pattern", [
    (K.HALO_SLOTS, "dense_advection.cu", r"constexpr int kSlots = (\d+);"),
    (G.GOL_HALO_SLOTS, "gol.cu", r"constexpr int kGolHaloSlots = (\d+);"),
    (R.RUN_THREADS, "dense_advection.cu",
     r"__launch_bounds__\((\d+), 1\)\s*dense_fused_run_kernel\("),
    (R.RUN_THREADS, "gol.cu", r"__launch_bounds__\((\d+), 1\)\s*gol_run_kernel\("),
], ids=["kSlots", "kGolHaloSlots", "fused_run_threads", "gol_run_threads"])
def test_plan_constants_match_the_kernels(value, source, pattern):
    """A constant the plan and its kernel share has one value in both."""
    found = re.findall(pattern, (CSRC / source).read_text())
    assert found == [str(value)]


# ------------------------------------------------------------ identities

def _fused_inputs(shape, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    nzl, ny, nx = shape
    mx, mzu = np.ones(nx), np.ones(nzl)
    mx[-1] = mzu[-1] = 0.0          # open x and z
    return (t(r.uniform(0.1, 1, shape)), *(t(r.normal(0, .5, shape)) for _ in range(3)),
            t(mx), t(np.ones(ny)), t(mzu), t(np.roll(mzu, 1)))


def test_z_minus_weight_is_the_z_plus_product_of_the_cell_below():
    """The reference's z- weight ((dt*vfz_lo)*az)*mzd equals, bitwise, the
    cell below's unmasked z+ product (dt*vfz_hi)*az times mzd, and its
    select the cell below's z+ select: B1 keeps one z product a cell."""
    rho, vx, vy, vz, mx, my, mzu, mzd = _fused_inputs((6, 5, 7), 3)
    dt, az = np.float32(0.013), np.float32(0.37)
    vfz_hi = (vz + torch.roll(vz, -1, 0)) * 0.5
    vfz_lo = (torch.roll(vz, 1, 0) + vz) * 0.5
    wzd = ((dt * vfz_lo) * az) * mzd.reshape(-1, 1, 1)
    below = torch.roll((dt * vfz_hi) * az, 1, 0)
    assert torch.equal((below * mzd.reshape(-1, 1, 1)).view(torch.int32),
                       wzd.view(torch.int32))
    assert torch.equal(torch.roll(vfz_hi >= 0, 1, 0), vfz_lo >= 0)


@pytest.mark.parametrize("shape,sms", [((6, 8, 10), 8), ((5, 7, 9), 27), ((3, 4, 2), 6)])
def test_fused_brick_step_equals_twin(shape, sms):
    """One step computed brick by brick, each brick from its one-cell halo
    and the minus-side weights as the plan cuts the block, equals the twin's
    step: what a CTA computes from its halo is what the twin computes."""
    rho, vx, vy, vz, mx, my, mzu, mzd = _fused_inputs(shape, 4)
    dt, area, inv_vol = 0.011, (0.3, 0.4, 0.5), 7.0
    want = K.fused_run_plain(rho, vx, vy, vz, mx, my, mzu, mzd, dt, 1,
                             area=area, inv_vol=inv_vol)
    full = K.fused_run_plain(rho, vx, vy, vz, mx, my, mzu, mzd, dt, 0,
                             area=area, inv_vol=inv_vol)
    plan = K.fused_run_plan(*shape, sms, 10 ** 9)
    got = torch.full_like(rho, float("nan"))
    for idx in np.ndindex(*plan.parts):
        spans = [R.part(n, p, i) for n, p, i in zip(shape, plan.parts, idx)]
        # a brick and its halo, gathered at wrapped block coordinates
        ix = [torch.arange(s - 1, s + n + 1) % N for (s, n), N in zip(spans, shape)]
        sub = lambda a: a[ix[0]][:, ix[1]][:, :, ix[2]]
        step = K.fused_run_plain(sub(full), sub(vx), sub(vy), sub(vz), mx[ix[2]],
                                 my[ix[1]], mzu[ix[0]], mzd[ix[0]], dt, 1,
                                 area=area, inv_vol=inv_vol)
        (z0, tz), (y0, ty), (x0, tx) = spans
        got[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx] = step[1:-1, 1:-1, 1:-1]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape,sms,k,turns", [((20, 24), 12, 3, 7), ((9, 11), 16, 2, 5),
                                               ((8, 8), 4, 4, 4)])
def test_gol_tile_rounds_equal_twin(shape, sms, k, turns, periodic):
    """Rounds of k turns on each tile and its k-deep halo of wrapped cells
    (each with its own validity masks), the tiles joined after each round,
    equal the twin bitwise, on a board of non-0/1 values: the recomputed
    halo sees the same 0 * x as the twin's roll."""
    r = np.random.default_rng(5)
    a = torch.tensor(r.choice([-1, 0, 0.5, 1, 2, 3], shape).astype(np.float32))
    want_a, want_c = G.gol_run_plain(a, turns, periodic, periodic)
    plan, _ = G._gol_plan_at(*shape, sms, 10 ** 9, k)
    ny, nx = shape
    vxh, vxl = G._validity(nx, periodic, a.device)
    vyh, vyl = G._validity(ny, periodic, a.device)
    cur, done = a.clone(), 0
    while done < turns:
        n = min(k, turns - done)
        nxt, cnt = torch.empty_like(cur), torch.empty_like(cur)
        for iy, ix in np.ndindex(*plan.parts):
            (y0, th), (x0, tw) = (R.part(N, p, i) for N, p, i in
                                  zip(shape, plan.parts, (iy, ix)))
            hy, hx = (k if p > 1 else 0 for p in plan.parts)
            ry = torch.arange(y0 - hy, y0 + th + hy) % ny
            rx = torch.arange(x0 - hx, x0 + tw + hx) % nx
            t, c = cur[ry][:, rx], None
            for _ in range(n):
                up = torch.roll(t, -1, 0) * vyh[ry].reshape(-1, 1)
                dn = torch.roll(t, 1, 0) * vyl[ry].reshape(-1, 1)
                t, c = G.gol_turn(up, t, dn, vxh[rx], vxl[rx])
            nxt[y0:y0 + th, x0:x0 + tw] = t[hy:hy + th, hx:hx + tw]
            cnt[y0:y0 + th, x0:x0 + tw] = c[hy:hy + th, hx:hx + tw]
        cur, done = nxt, done + n
    assert torch.equal(cur.view(torch.int32), want_a.view(torch.int32))
    assert torch.equal(cnt.view(torch.int32), want_c.view(torch.int32))
