"""Launch plan of the whole-solve BiCG kernel B8 (``bicg_solve``) and the
brick scheme its design rests on.

The plan is pure Python: the wrapper passes the plan it computes to the
kernel, so the plan tested here is the plan that runs on the card.  Checked:
a box-form plan hands every item to exactly one thread of one CTA, each CTA's
tiles whole (256 consecutive items, the dot order's tiles) and inside its
brick, at most one CTA an SM, at most 8 voxels a thread, the shared memory
within an H100's 227 KB; the l2 form cuts the tiles into runs; every grid
the dispatch (``bicg_fits``) admits has a plan, the main path's grids the
box form with everything on chip, the largest the l2 form; where nothing
fits, the plan refuses.  The constants the plan shares with the kernel are
pinned to the CUDA source.

The identity is exact: a solve computed brick by brick as the kernel
computes it — p0 and p1 held in boxes with a one-voxel halo, the halo
folded each iteration from the neighbours' published face residuals and
its own old values (p = r + beta p, no third barrier), every dot reduced
tile by tile in each CTA's tiles and then over the tile partials — equals
the twin (``bicg_solve_plain``), on uniform and two-level grids, bricks of
whole planes, rows and the whole grid, and at the residual and
semi-convergence stops.  Published residuals outside the bricks' faces are
NaN in the emulation, so a halo that read them would show.  The emulation
is also held against the JAX package's Pallas kernel in interpret mode at
``test_torch_poisson_kernel.py``'s tolerances.
"""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import dccrg_tpu
from dccrg_tpu.models import Poisson as JPoisson
from dccrg_tpu.ops import poisson_kernel as jk
from dccrg_tpu_torch.ops import poisson_kernel as B
from dccrg_tpu_torch.ops import resident as R

#: an H100 SXM's SM count and the shared memory one block may opt into
SMS, SMEM = 132, 227 * 1024
CSRC = pathlib.Path(B.__file__).resolve().parents[1] / "csrc"


def _item_grid(shape, has_coarse):
    sh = 1 if has_coarse else 0
    return tuple(n >> sh for n in shape)


def cta_items(plan, shape, has_coarse, c):
    """CTA c's tiles as (global tile index, its 256 item indices in thread
    order), as the kernel's ``item`` maps them; -1 past the grid's end."""
    Zi, Yi, Xi = _item_grid(shape, has_coarse)
    n = Zi * Yi * Xi
    k = plan.tiles_per_cta
    t = np.arange(B.TILE)
    if plan.tile_shape == (0, 0, 0):
        out = []
        for j in range(k):
            b = j * B.TILE + t
            out.append((j, np.where(b < n, b, -1)))
        return out
    sh = 1 if has_coarse else 0
    bzi, byi, bxi = (b >> sh for b in plan.brick)
    tp, tr, tw = plan.tile_shape
    nbx, nby = Xi // bxi, Yi // byi
    ox, oy, oz = c % nbx * bxi, c // nbx % nby * byi, c // (nbx * nby) * bzi
    ntx, nty = bxi // tw, byi // tr
    out = []
    for j in range(k):
        jx, jy, jz = j % ntx, j // ntx % nty, j // (ntx * nty)
        iz = jz * tp + t // (tr * tw)
        iy = jy * tr + t // tw % tr
        ix = jx * tw + t % tw
        b = ((oz + iz) * Yi + oy + iy) * Xi + ox + ix
        out.append((int(b[0]) // B.TILE, b))
    return out


def _check_plan(shape, has_coarse, plan, sms=SMS, smem=SMEM):
    Zi, Yi, Xi = _item_grid(shape, has_coarse)
    n = Zi * Yi * Xi
    E = 8 if has_coarse else 1
    assert plan.tiles == -(-n // B.TILE) <= B._MAX_TILES
    assert 1 <= plan.ctas <= min(sms, plan.tiles) and plan.threads == B.TILE
    assert plan.smem_bytes <= smem
    if plan.form == "l2":
        assert plan.smem_bytes == B.BICG_L2_BYTES and plan.ctas == min(sms, plan.tiles)
        runs = [R.part(plan.tiles, plan.ctas, i) for i in range(plan.ctas)]
        assert sum(m for _, m in runs) == plan.tiles
        assert max(m for _, m in runs) == plan.tiles_per_cta
        return
    k = plan.tiles_per_cta
    assert plan.form == "box" and plan.voxels_per_thread == k * E <= B.BICG_MAX_VOXELS
    assert plan.smem_bytes == B.bicg_box_bytes(plan.brick, k)
    assert all(b <= m for b, m in zip(plan.brick, B.BICG_MAX_BRICK))
    seen = np.zeros(n, np.int32)
    tiles = np.zeros(plan.tiles, np.int32)
    sh = 1 if has_coarse else 0
    bzi, byi, bxi = (b >> sh for b in plan.brick)
    for c in range(plan.ctas):
        mine = []
        for tid, b in cta_items(plan, shape, has_coarse, c):
            valid = b[b >= 0]
            # a tile: 256 consecutive items from tid * 256 (the dot order's)
            assert np.array_equal(valid, tid * B.TILE + np.arange(len(valid)))
            tiles[tid] += 1
            mine.append(valid)
        mine = np.concatenate(mine)
        seen[mine] += 1
        z, y, x = mine // (Yi * Xi), mine // Xi % Yi, mine % Xi
        # inside one brick-sized box
        assert (z.max() - z.min() < bzi and y.max() - y.min() < byi
                and x.max() - x.min() < bxi)
        assert len(mine) == bzi * byi * bxi or plan.ctas == 1
    assert np.all(seen == 1) and np.all(tiles == 1)


MAIN = [((64, 64, 64), True), ((64, 64, 64), False)]


def test_main_path_plans_keep_everything_on_chip():
    """The poisson and poisson_uniform grids: 128 CTAs, one a brick of
    2x16x64 (one tile of 2x2x2 items) or 4x8x64 voxels (8 tiles of 4 rows),
    p boxes and weights in shared memory, the state in registers."""
    p, u = (B.bicg_solve_plan(*s, hc, SMS, SMEM) for s, hc in MAIN)
    for plan, (s, hc) in zip((p, u), MAIN):
        _check_plan(s, hc, plan)
        assert plan.form == "box" and plan.ctas == 128 and "wpx" in plan.shared
        assert plan.voxels_per_thread == 8 and plan.l2 == ("r0, r1 brick faces",)
    assert p.brick == (2, 16, 64) and p.tile_shape == (1, 8, 32)
    assert u.brick == (4, 8, 64) and u.tile_shape == (1, 4, 64)


SHAPES = [((64, 64, 64), True), ((64, 64, 64), False), ((5, 7, 9), False),
          ((4, 6, 8), True), ((8, 16, 32), True), ((8, 16, 32), False),
          ((2048, 1, 1), False), ((1, 1, 4096), False), ((16, 16, 32), True),
          ((100, 98, 98), True), ((98, 98, 100), False), ((24, 24, 24), True)]


@pytest.mark.parametrize("shape,hc", SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plan_tiles_and_fits(shape, hc):
    _check_plan(shape, hc, B.bicg_solve_plan(*shape, hc, SMS, SMEM))


def test_largest_grids_take_the_l2_form():
    """The largest grids bicg_fits admits (~99^3) do not fit the box form's
    8 voxels a thread on 132 SMs: the plan says so before launch."""
    for shape, hc in (((100, 98, 98), True), ((98, 98, 100), False)):
        n = int(np.prod(shape))
        assert B.bicg_fits(n) and not B.bicg_fits(n + 98 * 98)
        plan = B.bicg_solve_plan(*shape, hc, SMS, SMEM)
        assert plan.form == "l2" and plan.ctas == SMS and "p0" in plan.l2


def test_bricks_that_do_not_fit_take_the_l2_form():
    """With shared memory a little short of a brick's boxes, weights and
    halo table, the plan takes the l2 form, decided before launch; the
    only admitted grids that come to it on an H100 (227 KB) are rows of
    262,144 voxels, whose bricks would be 2,048 voxels long."""
    full = B.bicg_solve_plan(64, 64, 64, True, SMS, SMEM)
    tight = B.bicg_box_bytes(full.brick, 1) - 4
    plan = B.bicg_solve_plan(64, 64, 64, True, SMS, tight)
    _check_plan((64, 64, 64), True, plan, smem=tight)
    assert plan.form == "l2" and set(B._WEIGHTS) <= set(plan.l2)
    assert B.bicg_fits(262144)
    for shape in ((1, 1, 262144), (1, 262144, 1)):
        plan = B.bicg_solve_plan(*shape, False, SMS, SMEM)
        _check_plan(shape, False, plan)
        assert plan.form == "l2"


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(nz=st.integers(1, 130), ny=st.integers(1, 130), nx=st.integers(1, 130),
       hc=st.booleans(), sms=st.sampled_from([1, 4, 16, 132]))
def test_plan_fits_every_admitted_grid(nz, ny, nx, hc, sms):
    """Every grid bicg_fits admits (even extents where it has coarse rows)
    has a plan on cards of 1 to 132 SMs."""
    if hc:
        nz, ny, nx = (2 * ((n + 1) // 2) for n in (nz, ny, nx))
    if not B.bicg_fits(nz * ny * nx):
        return
    shape = (nz, ny, nx)
    _check_plan(shape, hc, B.bicg_solve_plan(*shape, hc, sms, SMEM), sms=sms)


@pytest.mark.parametrize("args,match", [
    ((64, 64, 64, True, SMS, 1000), "not even the l2 form"),
    ((128, 128, 257, False, SMS, SMEM), "dot tiles exceed"),
    ((64, 64, 63, True, SMS, SMEM), "bad shape"),
], ids=["smem", "tiles", "odd-coarse"])
def test_plan_refuses_what_does_not_fit(args, match):
    with pytest.raises(ValueError, match=match):
        B.bicg_solve_plan(*args)


@pytest.mark.parametrize("value,pattern", [
    (B.TILE, r"constexpr int kThreads = (\d+);"),
    (B.BICG_MAX_LEVEL2, r"constexpr int kMaxLevel2 = (\d+);"),
    (B.BICG_MAX_VOXELS, r"constexpr int kMaxVoxels = (\d+);"),
    (B.BICG_DOTS, r"constexpr int kDots = (\d+);"),
    (B.BICG_MAX_BRICK, r"constexpr int kMaxBrick\[3\] = \{(\d+), (\d+), (\d+)\};"),
], ids=["kThreads", "kMaxLevel2", "kMaxVoxels", "kDots", "kMaxBrick"])
def test_plan_constants_match_the_kernel(value, pattern):
    src = (CSRC / "poisson.cu").read_text()
    want = tuple(map(str, value)) if isinstance(value, tuple) else str(value)
    assert re.findall(pattern, src) == [want]
    assert src.count("__launch_bounds__(kThreads, 1)") == 2


# ------------------------------------------------------------ the identity

def _sub(a, z, y, x):
    return a[z][:, y][:, :, x]


class _Brick:
    """One CTA's brick: its voxel slices, index vectors of its own cells
    and of the wrapped planes around them, and its p boxes."""

    def __init__(self, origin, ext, shape):
        self.o, self.e = origin, ext
        nz, ny, nx = shape
        self.own = tuple(torch.arange(o, o + e) for o, e in zip(origin, ext))
        self.box = tuple(torch.arange(o - 1, o + e + 1) % n
                         for o, e, n in zip(origin, ext, shape))
        self.sl = tuple(slice(o, o + e) for o, e in zip(origin, ext))
        bz, by, bx = ext
        self.face = torch.zeros(ext, dtype=torch.bool)
        for ax in range(3):
            idx = [slice(None)] * 3
            idx[ax] = 0
            self.face[tuple(idx)] = True
            idx[ax] = -1
            self.face[tuple(idx)] = True
        nan = float("nan")
        self.P0 = torch.full((bz + 2, by + 2, bx + 2), nan)
        self.P1 = torch.full((bz + 2, by + 2, bx + 2), nan)

    def halo_faces(self):
        """(box slice, global indices) of the six halo faces."""
        z, y, x = self.own
        bz, by, bx = self.box
        i = slice(1, -1)
        return [((i, i, slice(0, 1)), (z, y, bx[:1])), ((i, i, slice(-1, None)), (z, y, bx[-1:])),
                ((i, slice(0, 1), i), (z, by[:1], x)), ((i, slice(-1, None), i), (z, by[-1:], x)),
                ((slice(0, 1), i, i), (bz[:1], y, x)), ((slice(-1, None), i, i), (bz[-1:], y, x))]

    def fill_halo(self, G0, G1, beta=None):
        for sl, g in self.halo_faces():
            for P, G in ((self.P0, G0), (self.P1, G1)):
                v = _sub(G, *g)
                P[sl] = v if beta is None else v + beta * P[sl]


def _pool(C, coarse, orig, fine):
    """The kernel's coarse pool of a brick's face parts: each 2x2x2
    block's tree (x pairs, then y, then z) times orig at its origin,
    broadcast; fine C plus it."""
    s = C * coarse
    u = [s[e >> 2::2, (e >> 1) & 1::2, e & 1::2] for e in range(8)]
    pooled = ((u[0] + u[1]) + (u[2] + u[3])) + ((u[4] + u[5]) + (u[6] + u[7]))
    pooled = pooled * orig[::2, ::2, ::2]
    up = pooled.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return fine * C + up


def _matvec(br, P, W, scaling, masks, rev, has_coarse):
    """A·p (or Aᵀ·p) at a brick's voxels from its box: the twin's terms
    and association, the transpose's weights at the neighbours."""
    z, y, x = br.own
    bz, by, bx = br.box
    v = P[1:-1, 1:-1, 1:-1]
    nb = {"xp": P[1:-1, 1:-1, 2:], "xm": P[1:-1, 1:-1, :-2], "yp": P[1:-1, 2:, 1:-1],
          "ym": P[1:-1, :-2, 1:-1], "zp": P[2:, 1:-1, 1:-1], "zm": P[:-2, 1:-1, 1:-1]}
    (wpx, wnx), (wpy, wny), (wpz, wnz) = W
    if not rev:
        own = lambda w: _sub(w, z, y, x)
        terms = [(own(wpx) * nb["xp"], own(wnx) * nb["xm"]),
                 (own(wpy) * nb["yp"], own(wny) * nb["ym"]),
                 (own(wpz) * nb["zp"], own(wnz) * nb["zm"])]
    else:
        terms = [(_sub(wpx, z, y, bx[:-2]) * nb["xm"], _sub(wnx, z, y, bx[2:]) * nb["xp"]),
                 (_sub(wpy, z, by[:-2], x) * nb["ym"], _sub(wny, z, by[2:], x) * nb["yp"]),
                 (_sub(wpz, bz[:-2], y, x) * nb["zm"], _sub(wnz, bz[2:], y, x) * nb["zp"])]
    C = None
    for a, b in terms:
        C = a + b if C is None else C + a + b
    if has_coarse:
        fine, coarse, orig = (m[br.sl] for m in masks)
        C = _pool(C, coarse, orig, fine)
    return scaling[br.sl] * v + C


def _items(w, has_coarse):
    """Per-item values of a voxel array: a coarse item's 8 as the tree at
    strides 4, 2, 1."""
    if has_coarse:
        nz, ny, nx = w.shape
        w = B._tree(w.reshape(nz // 2, 2, ny // 2, 2, nx // 2, 2)
                    .permute(0, 2, 4, 1, 3, 5).reshape(-1, 8))
    return w.reshape(-1)


def _totals(parts):
    v = parts
    while v.numel() > 1:
        v = B._tile_level(v)
    return v[0]


def emulate_bicg(plan, arrays, max_iter, stop_res, stop_inc, has_coarse):
    """B8's box form on the CPU, brick by brick."""
    (rhs, x0, wpx, wnx, wpy, wny, wpz, wnz, scaling, fine, coarse, orig,
     solve_m, dot_m) = arrays
    assert plan.form == "box"
    shape = tuple(rhs.shape)
    W = ((wpx, wnx), (wpy, wny), (wpz, wnz))
    masks = (fine, coarse, orig)
    sh = 1 if has_coarse else 0
    f32 = lambda v: torch.tensor(np.float32(v))
    zero = f32(0.0)
    solve, dotm = solve_m != 0, dot_m != 0
    nbz, nby, nbx = (n // b for n, b in zip(shape, plan.brick))
    bricks = []
    for c in range(plan.ctas):
        if plan.tile_shape == (0, 0, 0):
            origin = (0, 0, 0)
        else:
            origin = (c // (nbx * nby) * plan.brick[0], c // nbx % nby * plan.brick[1],
                      c % nbx * plan.brick[2])
        bricks.append(_Brick(origin, plan.brick, shape))
    tiles = [cta_items(plan, shape, has_coarse, c) for c in range(plan.ctas)]

    def dot(per_brick):
        """The dot of per-brick voxel values in the kernel's order: each
        CTA's tiles' trees, then the tile partials' levels."""
        w = torch.full(shape, float("nan"))
        for br, v in zip(bricks, per_brick):
            w[br.sl] = v
        items = _items(w, has_coarse)
        parts = torch.full((plan.tiles,), float("nan"))
        for cta in tiles:
            for tid, b in cta:
                vals = torch.where(torch.from_numpy(b >= 0), items[np.maximum(b, 0)], zero)
                parts[tid] = B._tree(vals.reshape(1, -1))[0]
        return _totals(parts)

    R0g = torch.full(shape, float("nan"))
    R1g = torch.full(shape, float("nan"))
    x0box = [_sub(x0, *br.box) for br in bricks]
    X, R0, R1, BEST = [], [], [], []
    for br, xb in zip(bricks, x0box):
        bx = torch.full_like(br.P0, float("nan"))
        bx[1:-1, 1:-1, 1:-1] = xb[1:-1, 1:-1, 1:-1]
        for sl, g in br.halo_faces():
            bx[sl] = _sub(x0, *g)
        Ax = _matvec(br, bx, W, scaling, masks, False, has_coarse)
        r = torch.where(solve[br.sl], rhs[br.sl] - Ax, zero)
        X.append(x0[br.sl].clone())
        BEST.append(x0[br.sl].clone())
        R0.append(r)
        R1.append(r)
        br.P0[1:-1, 1:-1, 1:-1] = r
        br.P1[1:-1, 1:-1, 1:-1] = r
        R0g[br.sl] = torch.where(br.face, r, R0g[br.sl])
        R1g[br.sl] = torch.where(br.face, r, R1g[br.sl])
    dot_r = dot([torch.where(dotm[br.sl], r * r, zero) for br, r in zip(bricks, R0)])
    res = torch.sqrt(torch.abs(dot_r))
    best_res = res
    for br in bricks:
        br.fill_halo(R0g, R1g)
    it = 0
    stop_res, stop_inc = f32(stop_res), f32(stop_inc)
    while it < max_iter and bool((res > stop_res) & (dot_r != 0) & (res <= best_res * stop_inc)):
        mv = lambda br, P, rev: torch.where(
            solve[br.sl], _matvec(br, P, W, scaling, masks, rev, has_coarse), zero)
        AP = [mv(br, br.P0, False) for br in bricks]
        ATP = [mv(br, br.P1, True) for br in bricks]
        dot_p = dot([torch.where(dotm[br.sl], br.P1[1:-1, 1:-1, 1:-1] * ap, zero)
                     for br, ap in zip(bricks, AP)])
        alpha = torch.where(dot_p != 0, dot_r / dot_p, zero)
        for i, br in enumerate(bricks):
            X[i] = X[i] + alpha * br.P0[1:-1, 1:-1, 1:-1]
            R0[i] = R0[i] - alpha * AP[i]
            R1[i] = R1[i] - alpha * ATP[i]
            R0g[br.sl] = torch.where(br.face, R0[i], R0g[br.sl])
            R1g[br.sl] = torch.where(br.face, R1[i], R1g[br.sl])
        new_dot_r = dot([torch.where(dotm[br.sl], a * b, zero) for br, a, b in zip(bricks, R0, R1)])
        rr = dot([torch.where(dotm[br.sl], a * a, zero) for br, a in zip(bricks, R0)])
        beta = torch.where(dot_r != 0, new_dot_r / dot_r, zero)
        res_new = torch.sqrt(torch.abs(rr))
        better = bool(res_new < best_res)
        for i, br in enumerate(bricks):
            br.P0[1:-1, 1:-1, 1:-1] = R0[i] + beta * br.P0[1:-1, 1:-1, 1:-1]
            br.P1[1:-1, 1:-1, 1:-1] = R1[i] + beta * br.P1[1:-1, 1:-1, 1:-1]
            br.fill_halo(R0g, R1g, beta)
            if better:
                BEST[i] = X[i].clone()
        if better:
            best_res = res_new
        dot_r, res = new_dot_r, res_new
        it += 1
    out = torch.full(shape, float("nan"))
    for br, b in zip(bricks, BEST):
        out[br.sl] = b
    return out, best_res.reshape(1), torch.tensor([it], dtype=torch.int32)


def synth(shape, hc, seed):
    """Seeded float32 solve operands: a perturbed Laplacian with random
    positive face weights, 90% solve rows, and, with coarse rows, fine /
    coarse 2x2x2 blocks and the even-parity origins."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    w = [r.uniform(0.5, 1.5, shape) for _ in range(6)]
    scaling = -sum(w) * r.uniform(1.0, 1.1, shape)
    if hc:
        blk = r.random(tuple(n // 2 for n in shape)) < 0.5
        fine = blk.repeat(2, 0).repeat(2, 1).repeat(2, 2)
        g = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij", sparse=True)
        orig = (g[0] % 2 == 0) & (g[1] % 2 == 0) & (g[2] % 2 == 0)
    else:
        fine, orig = np.ones(shape, bool), np.zeros(shape, bool)
    solve = r.random(shape) < 0.9
    rhs = np.where(solve, r.standard_normal(shape), 0.0)
    x0 = 0.1 * r.standard_normal(shape)
    return [t(rhs), t(x0)] + [t(a) for a in w] + [t(scaling), t(fine), t(~fine),
                                                  t(orig), t(solve), t(solve)]


@pytest.mark.parametrize("shape,hc,sms,scalars", [
    ((8, 16, 32), False, 4, (25, 0.0, np.inf)),
    ((8, 16, 32), True, 4, (25, 0.0, np.inf)),
    ((16, 16, 32), True, 8, (12, 0.0, np.inf)),
    ((5, 7, 9), False, 132, (200, 1e-3, 10.0)),
    ((4, 6, 8), True, 132, (60, 1e-4, 10.0)),
    ((12, 4, 8), False, 2, (30, 1e-5, 10.0)),
], ids=["rows", "coarse-planes", "coarse-4-bricks", "whole-odd", "whole-coarse", "planes"])
def test_brick_scheme_equals_twin(shape, hc, sms, scalars):
    """The brick scheme on plans of several bricks (whole rows, whole
    planes, coarse items) and of one whole-grid brick of consecutive tiles
    equals the twin: the solution, best residual and iteration count."""
    arrays = synth(shape, hc, sum(shape) + sms)
    plan = B.bicg_solve_plan(*shape, hc, sms, SMEM)
    assert plan.form == "box"
    _check_plan(shape, hc, plan, sms=sms)
    want = B.bicg_solve_plain(*arrays, *scalars, has_coarse=hc)
    got = emulate_bicg(plan, arrays, *scalars, hc)
    assert int(got[2][0]) == int(want[2][0]) > 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@functools.lru_cache(maxsize=None)
def _jax_inputs(n, refine):
    """The JAX model's fused-solve operands on an n^3 grid (a refined ball
    or uniform), a seeded random rhs."""
    g = (dccrg_tpu.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(mesh=dccrg_tpu.make_mesh(n_devices=1)))
    if refine:
        ids = g.get_cells()
        c = g.geometry.get_center(ids)
        for cid in ids[np.linalg.norm(c - 0.5, axis=1) < 0.3]:
            g.refine_completely(int(cid))
        g.stop_refining()
    p = JPoisson(g, dtype=np.float32, use_pallas="interpret")
    t = p._flat_tables
    s = p.initialize_state(np.random.default_rng(5).standard_normal(len(g.get_cells())))
    _f, _r, vox, _wb, m = p._flat
    f32 = lambda a: np.asarray(a, np.float32)
    arrays = ([f32(jnp.where(m["solve"], vox(s["rhs"]), 0.0)), f32(vox(s["solution"]))]
              + [f32(w) for pair in t["weights"] for w in pair]
              + [f32(a) for a in (t["scaling"], t["fine"], ~t["fine"], t["orig"],
                                  t["solve"], t["dot_mask"])])
    return tuple(arrays), bool(t["has_coarse"])


@pytest.mark.parametrize("n,refine,sms,stop_res", [(8, True, 132, 1e-5), (8, False, 2, 1e-3)],
                         ids=["refined-16^3-voxels", "uniform-8^3"])
def test_brick_scheme_matches_pallas(n, refine, sms, stop_res):
    """The emulation against ``make_bicg_solve(..., interpret=True)`` on
    the JAX model's tables, with test_torch_poisson_kernel.py's residual
    targets and tolerances (test_fused_bicg_matches_xla_flat's): iterations
    within 1; with equal counts the best residual at rel 1e-5 and the
    solution at rtol 1e-5 / atol 1e-7."""
    arrays, hc = _jax_inputs(n, refine)
    assert hc == refine
    shape = arrays[0].shape
    plan = B.bicg_solve_plan(*shape, hc, sms, SMEM)
    assert plan.form == "box" and plan.ctas > 1
    scalars = (60, stop_res, 10.0)
    tx, tr, ti = emulate_bicg(plan, [torch.tensor(a) for a in arrays], *scalars, hc)
    kern = jk.make_bicg_solve(shape, hc, interpret=True)
    jx, jr, ji = kern(*[jnp.asarray(a) for a in arrays], *scalars)
    jx, jr, ji = np.asarray(jx), float(jr[0]), int(ji[0])
    assert abs(ji - int(ti[0])) <= 1 and int(ti[0]) > 3
    if ji == int(ti[0]):
        assert float(tr[0]) == pytest.approx(jr, rel=1e-5)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-5, atol=1e-7)
    else:
        assert jr <= stop_res and float(tr[0]) <= stop_res
        np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-3, atol=1e-6)
