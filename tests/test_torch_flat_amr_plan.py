"""Launch plans of the on-chip flat AMR kernels B5 (``flat_amr_run``) and B6
(``flat_ml_run``), and the identities their designs rest on.

The plans are pure Python: the wrapper passes the plan it computes to the
kernel, so the plan tested here is the plan that runs on the card.  Checked:
the bricks cover every voxel exactly once and are aligned to the pooling
cube, a CTA's shared memory fits an H100's 227 KB and the CTAs its 132 SMs,
a thread's units fit its registers' budget, at the main-path shapes and at
every grid the dispatch thresholds (``flat_amr_fits``,
``flat_ml_kernel_fits``) admit; where nothing fits, the plan refuses.  The
constants a plan shares with its kernel are pinned to the CUDA source.

The identities are exact (bitwise): a step computed brick by brick, each
brick from its one-voxel density halo and its weight layouts (each axis's
pair with one plane on the minus side), pooled unit by unit in the
kernels' tree order, equals the twin's step, over several steps (the halos
refreshed from the bricks between steps), at wrap faces and for odd step
counts.  The emulation is also held against the JAX kernels in interpret
mode, as the twins are in ``test_torch_flat_amr_kernels.py``.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dccrg_tpu.ops import flat_amr as jf
from dccrg_tpu_torch.ops import flat_amr as F
from dccrg_tpu_torch.ops import resident as R

#: an H100 SXM's SM count and the shared memory one block may opt into
SMS, SMEM = 132, 227 * 1024
CSRC = pathlib.Path(F.__file__).resolve().parents[1] / "csrc"
EPS32 = float(np.finfo(np.float32).eps)


def _spans(shape, plan):
    """Per axis, the (start, length) in voxels of each part."""
    a = plan.align
    return [[(s * a, n * a) for s, n in (R.part(N // a, p, i) for i in range(p))]
            for N, p in zip(shape, plan.parts)]


def _check_plan(shape, plan, kmax):
    spans = _spans(shape, plan)
    hits = np.zeros(shape, dtype=np.int32)
    for idx in np.ndindex(*plan.parts):
        sl = tuple(slice(s, s + n) for s, n in (spans[a][i] for a, i in enumerate(idx)))
        hits[sl] += 1
    assert np.all(hits == 1)
    assert all(n % plan.align == 0 for n in shape)
    assert plan.ctas == int(np.prod(plan.parts)) <= SMS
    assert plan.tile == tuple(max(n for _, n in sp) for sp in spans)
    tvox = int(np.prod(plan.tile))
    boxes = 1 if plan.units_per_thread else 2
    assert plan.smem_bytes == F.flat_smem_bytes(
        plan.tile, boxes, plan.weights_on_chip, F.flat_pool_floats(tvox, kmax),
        F.flat_halo_cells(plan.tile, plan.parts)) <= SMEM
    assert 32 <= plan.threads <= R.RUN_THREADS and plan.threads % 32 == 0
    if kmax >= 0:
        kb = plan.units_per_thread
        assert 1 <= kb <= F.FLAT_MAX_UNITS and plan.threads <= F.FLAT_UNIT_THREADS[kb]
        assert tvox // 8 <= kb * plan.threads
        # the fewest units a thread that the unit threads allow
        assert kb == 1 or tvox // 8 > (kb - 1) * F.FLAT_UNIT_THREADS[kb - 1]
    else:
        assert plan.units_per_thread == 0 and "updf" in plan.l2
    tz, ty, tx = plan.tile
    assert plan.face_floats >= max(tz * ty, tz * tx, ty * tx)
    weights = {"wpx", "wnx", "wpy", "wny", "wpz", "wnz"}
    assert weights <= set(plan.shared if plan.weights_on_chip else plan.l2)


AMR_SHAPES = [(96, 96, 96), (34, 18, 26), (110, 110, 114), (2, 2, 2), (2, 2, 349524),
              (349524, 2, 2), (4, 6, 8), (64, 2, 98)]


@pytest.mark.parametrize("shape", AMR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flat_amr_plan_tiles_and_fits(shape):
    assert F.flat_amr_fits(int(np.prod(shape)))
    _check_plan(shape, F.flat_amr_run_plan(*shape, SMS, SMEM), 0)


ML_SHAPES = [((64, 64, 64), 1), ((64, 64, 64), 2), ((104, 108, 112), 1), ((16, 16, 16), 3),
             ((4, 8, 12), 0), ((9, 7, 5), -1), ((1, 1, 1), -1), ((96, 96, 128), 3)]


@pytest.mark.parametrize("shape,kmax", ML_SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_flat_ml_plan_tiles_and_fits(shape, kmax):
    _check_plan(shape, F.flat_ml_run_plan(*shape, kmax, SMS, SMEM), kmax)


def test_main_path_plans_keep_everything_on_chip():
    """At the refined grids' voxels (96^3, 64^3 at kmax 1) nothing is read
    from L2: the weights sit in shared memory, masks in registers."""
    p5 = F.flat_amr_run_plan(96, 96, 96, SMS, SMEM)
    assert p5.weights_on_chip and p5.l2 == () and p5.ctas == 128
    assert p5.units_per_thread == 2 and p5.threads == 448 and p5.tile in ((12, 24, 24), (24, 12, 24), (24, 24, 12))
    p6 = F.flat_ml_run_plan(64, 64, 64, 1, SMS, SMEM)
    assert p6.weights_on_chip and p6.l2 == () and p6.ctas == 128
    assert p6.units_per_thread == 1 and p6.threads == 256


def test_largest_grids_read_weights_from_l2():
    """Where the weights do not fit beside the box, the plan says so before
    launch: they are read from L2, everything else stays where it was."""
    p = F.flat_amr_run_plan(110, 110, 114, SMS, SMEM)
    assert not p.weights_on_chip and set(p.l2) == {"wpx", "wnx", "wpy", "wny", "wpz", "wnz"}
    assert p.shared == ("density",) and "upd_f" in p.registers


@pytest.mark.parametrize("vals", [
    (2, 4, 6, 10, 22, 34, 48, 64, 96, 98, 110),
    (128, 200, 256, 514, 1000, 2048, 4096, 65536, 174762),
], ids=["small", "large"])
def test_flat_amr_plan_fits_every_admitted_grid(vals):
    """For even (ny, nx) over the list, the deepest grid the dispatch admits
    (and so every shallower one, whose bricks are no larger) has a plan, in
    every axis order."""
    nmax = F._FLAT_VMEM_BUDGET // (F._FLAT_ARRAYS * 4)
    for ny in vals:
        for nx in vals:
            if ny * nx * 2 > nmax:
                continue
            nz = nmax // (ny * nx) // 2 * 2
            n = nz * ny * nx
            assert F.flat_amr_fits(n) and not F.flat_amr_fits(n + 2 * ny * nx)
            for shape in ((nz, ny, nx), (nx, nz, ny), (ny, nx, nz)):
                _check_plan(shape, F.flat_amr_run_plan(*shape, SMS, SMEM), 0)


@pytest.mark.parametrize("vl", [2, 3, 4])
def test_flat_ml_plan_fits_every_admitted_grid(vl):
    """As above for B6 at each doubling the pooling can reach (kmax up to
    vl - 1; bricks aligned to 2^(kmax+1)), on grids of 2^vl-voxel leaves."""
    E = 1 << vl
    nmax = F._FLAT_VMEM_BUDGET // ((F._FLAT_ARRAYS + vl) * 4)
    for ny in (E * k for k in (1, 2, 3, 7, 16, 33)):
        for nx in (E * k for k in (1, 3, 5, 13, 64, 270)):
            if ny * nx * E > nmax:
                continue
            nz = nmax // (ny * nx) // E * E
            assert F.flat_ml_kernel_fits(nz * ny * nx, vl)
            assert not F.flat_ml_kernel_fits((nz + E) * ny * nx, vl)
            for shape in ((nz, ny, nx), (nx, nz, ny), (ny, nx, nz)):
                for kmax in range(-1, vl):
                    _check_plan(shape, F.flat_ml_run_plan(*shape, kmax, SMS, SMEM), kmax)


@pytest.mark.parametrize("fn,args", [
    (F.flat_amr_run_plan, (96, 96, 96, 132, 20_000)),
    (F.flat_amr_run_plan, (96, 96, 96, 1, SMEM)),
    (F.flat_ml_run_plan, (64, 64, 64, 1, 4, 30_000)),
    (F.flat_ml_run_plan, (9, 7, 5, -1, 132, 100)),
], ids=["amr-smem", "amr-units", "ml-smem", "ml-plain-smem"])
def test_flat_plans_refuse_what_does_not_fit(fn, args):
    with pytest.raises(ValueError, match="no cut of the .* fits"):
        fn(*args)


@pytest.mark.parametrize("fn,args", [(F.flat_amr_run_plan, (96, 96, 95, SMS, SMEM)),
                                     (F.flat_ml_run_plan, (64, 64, 66, 1, SMS, SMEM))],
                         ids=["odd", "not-E-aligned"])
def test_flat_plans_refuse_unaligned_grids(fn, args):
    with pytest.raises(ValueError, match="is not a grid of"):
        fn(*args)


@pytest.mark.parametrize("value,pattern", [
    (F.FLAT_MAX_UNITS, r"constexpr int kMaxUnits = (\d+);"),
    (R.RUN_THREADS, r"constexpr int kThreads = (\d+);"),
    ((F.FLAT_UNIT_THREADS[1], F.FLAT_UNIT_THREADS[2], F.FLAT_UNIT_THREADS[3]),
     r"return kb == 1 \? (\d+) : kb == 2 \? (\d+) : (\d+);"),
], ids=["kMaxUnits", "kThreads", "unit_threads"])
def test_flat_plan_constants_match_the_kernels(value, pattern):
    """A constant the plans and the kernels share has one value in both;
    the unit kernels are bounded by unit_threads, the plain one by
    kThreads."""
    src = (CSRC / "flat_amr.cu").read_text()
    if isinstance(value, tuple):
        value = tuple(map(str, value))
        assert F.FLAT_UNIT_THREADS[4] == F.FLAT_UNIT_THREADS[3]
    else:
        value = str(value)
    assert re.findall(pattern, src) == [value]
    assert len(re.findall(r"__launch_bounds__\(unit_threads\(KB\), 1\)", src)) == 2
    assert len(re.findall(r"__launch_bounds__\(kThreads, 1\)", src)) == 1


# ------------------------------------------------------------ identities

def _tree8(s):
    """The unit tree of 8 values s[e], e = dz*4 + dy*2 + dx: x pairs, then
    y, then z."""
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


def _cube_tree(a):
    """The tree over each aligned 2x2x2 group of ``a`` [z, y, x]."""
    return _tree8([a[dz::2, dy::2, dx::2] for dz in (0, 1) for dy in (0, 1)
                   for dx in (0, 1)])


def _units(a):
    """``a`` [tz, ty, tx] as the 8 voxel arrays of its 2x2x2 units."""
    return [a[e >> 2::2, (e >> 1) & 1::2, e & 1::2] for e in range(8)]


def _bcast(u, f):
    """A per-cube array broadcast over cubes of edge f."""
    return u.repeat_interleave(f, 0).repeat_interleave(f, 1).repeat_interleave(f, 2)


class _Bricks:
    """A plan's bricks on the CPU: each brick's density box with its
    one-voxel halo (wrapped, refreshed from the whole grid between steps,
    as the face exchange and the self-wrap fill it), its weight layouts
    with one plane on each axis's minus side, and its global slices."""

    def __init__(self, shape, plan, w):
        self.shape, self.bricks = shape, []
        spans = _spans(shape, plan)
        for idx in np.ndindex(*plan.parts):
            (z0, tz), (y0, ty), (x0, tx) = (spans[a][i] for a, i in enumerate(idx))
            rz, ry, rx = (torch.arange(s - 1, s + n + 1) % N
                          for (s, n), N in zip(((z0, tz), (y0, ty), (x0, tx)), shape))
            sub = lambda a, z, y, x: a[z][:, y][:, :, x]
            lay = [sub(w[0], rz[1:-1], ry[1:-1], rx[:-1]), sub(w[1], rz[1:-1], ry[1:-1], rx[:-1]),
                   sub(w[2], rz[1:-1], ry[:-1], rx[1:-1]), sub(w[3], rz[1:-1], ry[:-1], rx[1:-1]),
                   sub(w[4], rz[:-1], ry[1:-1], rx[1:-1]), sub(w[5], rz[:-1], ry[1:-1], rx[1:-1])]
            sl = (slice(z0, z0 + tz), slice(y0, y0 + ty), slice(x0, x0 + tx))
            self.bricks.append((lambda a, rz=rz, ry=ry, rx=rx: sub(a, rz, ry, rx), lay, sl))

    def delta(self, box, lay):
        """The flux divergence of a brick's voxels from its box and
        layouts: the minus face of each axis reads the layout one plane
        before the voxel's own."""
        xp, xn, yp, yn, zp, zn = lay
        v = box[1:-1, 1:-1, 1:-1]
        fx = v * xp[:, :, 1:] + box[1:-1, 1:-1, 2:] * xn[:, :, 1:]
        fxm = box[1:-1, 1:-1, :-2] * xp[:, :, :-1] + v * xn[:, :, :-1]
        fy = v * yp[:, 1:] + box[1:-1, 2:, 1:-1] * yn[:, 1:]
        fym = box[1:-1, :-2, 1:-1] * yp[:, :-1] + v * yn[:, :-1]
        fz = v * zp[1:] + box[2:, 1:-1, 1:-1] * zn[1:]
        fzm = box[:-2, 1:-1, 1:-1] * zp[:-1] + v * zn[:-1]
        return v, ((((fxm - fx) + fym) - fy) + fzm) - fz

    def run(self, V, steps, unit_step):
        cur = V.clone()
        for _ in range(steps):
            nxt = torch.full_like(cur, float("nan"))
            for gather, lay, sl in self.bricks:
                nxt[sl] = unit_step(*self.delta(gather(cur), lay), sl)
            cur = nxt
        return cur


def emulate_flat_amr(plan, V, w, upd_f, upd_c, dt, steps):
    """B5 on the plan's bricks: a unit's 8 deltas, its pooled coarse
    deltas by the unit tree, res = (v + delta * upd_f) + pooled * upd_c."""
    bricks = _Bricks(tuple(V.shape), plan, F._premultiply(w, dt))

    def unit_step(v, d, sl):
        uf, uc = upd_f[sl], upd_c[sl]
        pooled = _bcast(_tree8(_units(d * (uc != 0).to(torch.float32))), 2)
        return (v + d * uf) + pooled * uc
    return bricks.run(V, steps, unit_step)


def emulate_flat_ml(plan, V, w, updf, pool, caps, dt, steps, cap_active):
    """B6 on the plan's bricks: r = delta * updf; per doubling k the tree
    of the 8 sub-cube values (the unit tree at k = 0), and, where k
    captures, r += pooled * caps[k] read at each cube's origin only."""
    bricks = _Bricks(tuple(V.shape), plan, F._premultiply(w, dt))
    kmax = F._kmax(cap_active)

    def unit_step(v, d, sl):
        r = d * updf[sl]
        if kmax < 0:
            return v + r
        p = _tree8(_units(d * pool[sl]))
        for k in range(kmax + 1):
            if k:
                p = _cube_tree(p)
            f = 2 << k
            if cap_active[k]:
                origin = caps[k][sl][::f, ::f, ::f]
                r = r + _bcast(p * origin, f)
        return v + r
    return bricks.run(V, steps, unit_step)


def _amr_inputs(shape, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    V = t(r.uniform(0.1, 1.0, shape))
    w = [t(r.uniform(-1e-2, 1e-2, shape)) for _ in range(6)]
    blk = r.random(tuple(n // 2 for n in shape)) < 0.5
    fine = blk.repeat(2, 0).repeat(2, 1).repeat(2, 2)
    return V, w, t(fine / 1.0), t(~fine / 8.0)


def _ml_inputs(shape, kmax, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32))
    V = t(r.uniform(0.1, 1.0, shape))
    w = [t(r.uniform(-1e-2, 1e-2, shape)) for _ in range(6)]
    g = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij", sparse=True)
    caps = []
    for k in range(kmax + 1):
        f = 2 << k
        origin = (g[0] % f == 0) & (g[1] % f == 0) & (g[2] % f == 0)
        caps.append(t((origin & (r.random(shape) < 0.6)) / 8.0 ** (k + 1)))
    return V, w, t(r.random(shape) < 0.5), t(r.random(shape) < 0.5), caps


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape,sms,steps", [((8, 12, 16), 8, 7), ((6, 10, 14), 27, 4),
                                             ((4, 6, 8), 132, 3), ((16, 16, 24), 1, 2)])
def test_flat_amr_bricks_equal_twin(shape, sms, steps):
    """Runs of B5's brick scheme on cuts into several bricks, wrap faces,
    one brick on each axis (its halo wrapped onto itself) and an odd step
    count equal the twin bitwise."""
    V, w, uf, uc = _amr_inputs(shape, sms)
    plan = F.flat_amr_run_plan(*shape, sms, 10 ** 9)
    want = F.flat_amr_run_plain(V, *w, uf, uc, 0.9, steps)
    got = emulate_flat_amr(plan, V, w, uf, uc, 0.9, steps)
    assert _same_bits(got, want)
    assert not torch.equal(got, V)


@pytest.mark.parametrize("shape,kmax,sms,steps,active", [
    ((8, 8, 16), 1, 8, 7, None), ((8, 12, 16), 0, 6, 5, None),
    ((16, 16, 16), 2, 4, 3, None), ((16, 16, 32), 3, 2, 2, (True, False, True, True)),
    ((9, 7, 5), -1, 8, 5, ())])
def test_flat_ml_bricks_equal_twin(shape, kmax, sms, steps, active):
    """The same for B6 at each pooling depth: captures at every doubling or
    some, cubes of edge 2 to 16, and the no-capture form on odd extents."""
    V, w, updf, pool, caps = _ml_inputs(shape, kmax, sms)
    cap_active = list(active if active is not None else [True] * (kmax + 1))
    plan = F.flat_ml_run_plan(*shape, F._kmax(cap_active), sms, 10 ** 9)
    want = F.flat_ml_run_plain(V, *w, updf, pool, caps, 0.9, steps, cap_active=cap_active)
    got = emulate_flat_ml(plan, V, w, updf, pool, caps, 0.9, steps, cap_active)
    assert _same_bits(got, want)
    assert not torch.equal(got, V)


def _tol(V, steps):
    return 4 * EPS32 * float(np.abs(V).max()) * max(steps, 1)


@pytest.mark.parametrize("steps", [1, 7])
def test_flat_amr_bricks_match_pallas(steps):
    """B5's brick scheme against ``make_flat_amr_run(..., interpret=True)``,
    at the twins' tolerance (test_torch_flat_amr_kernels.py)."""
    shape = (8, 12, 16)
    V, w, uf, uc = _amr_inputs(shape, 30 + steps)
    plan = F.flat_amr_run_plan(*shape, 8, 10 ** 9)
    got = emulate_flat_amr(plan, V, w, uf, uc, 0.9, steps).numpy()
    kern = jf.make_flat_amr_run(*shape, interpret=True)
    want = np.asarray(kern(*(jnp.asarray(a.numpy()) for a in (V, *w, uf, uc)),
                           np.float32(0.9), steps))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(V.numpy(), steps))


@pytest.mark.parametrize("steps", [1, 7])
def test_flat_ml_bricks_match_pallas(steps):
    """B6's brick scheme against ``make_flat_ml_run_pallas(...,
    interpret=True)`` with three capturing doublings."""
    shape, kmax = (16, 16, 16), 2
    V, w, updf, pool, caps = _ml_inputs(shape, kmax, 40 + steps)
    cap_active = [True] * (kmax + 1)
    plan = F.flat_ml_run_plan(*shape, kmax, 4, 10 ** 9)
    got = emulate_flat_ml(plan, V, w, updf, pool, caps, 0.9, steps, cap_active).numpy()
    kern = jf.make_flat_ml_run_pallas(*shape, kmax + 1, cap_active, interpret=True)
    want = np.asarray(kern(*(jnp.asarray(a.numpy()) for a in (V, *w, updf, pool)),
                           [jnp.asarray(c.numpy()) for c in caps], np.float32(0.9), steps))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(V.numpy(), steps))
