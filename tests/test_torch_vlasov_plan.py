"""Launch plan of the Vlasov step kernel B7 (``vlasov_step``) and the tile
scheme its design rests on.

The plan is pure Python: the wrapper passes the plan it computes to the
kernel, so the plan tested here is the plan that runs on the card.  Checked:
the tiles, bin chunks and z runs cover every phase-space cell exactly once,
a CTA's windows fit an H100's 227 KB and its threads the kernel's launch
bound, the CTAs fill at most one wave, at the main path's shape and at
every shape the dispatch threshold (``pick_vlasov_block``) admits; where
nothing fits, the plan refuses.  The constants the plan shares with the
kernel are pinned to the CUDA source.

The identity is exact (bitwise): a step computed CTA by CTA as the kernel
computes it — each plane's wrapped (ty+2) x (tx+2) x chunk window, the x
split of its rows, the y split, the z split marching up the run, every
split reading only its upwind neighbour — equals the twin's step, on
periodic and open axes, one and several slabs, bin counts 1, 27, 64 and 512
and ragged chunks.  The emulation is also held against the JAX kernel in
interpret mode at the twin's tolerance (``test_torch_vlasov_kernel.py``).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dccrg_tpu.ops.vlasov_kernel import make_vlasov_step_blocked
from dccrg_tpu_torch.ops import resident as R
from dccrg_tpu_torch.ops import vlasov_kernel as V

#: an H100 SXM's SM count and the shared memory one block may opt into
SMS, SMEM = 132, 227 * 1024
CSRC = pathlib.Path(V.__file__).resolve().parents[1] / "csrc"


def _check_plan(shape, plan, sms=SMS, smem=SMEM):
    D, nzl, ny, nx, B = shape
    n_ty, n_tx = plan.tiles
    ys = [R.part(ny, n_ty, i) for i in range(n_ty)]
    xs = [R.part(nx, n_tx, i) for i in range(n_tx)]
    zs = [R.part(nzl, plan.z_parts, i) for i in range(plan.z_parts)]
    # tiles, chunks and z runs cover each axis exactly once
    for spans, n in ((ys, ny), (xs, nx), (zs, nzl)):
        assert spans[0][0] == 0 and sum(n_ for _, n_ in spans) == n
        assert all(a + la == b for (a, la), (b, _) in zip(spans, spans[1:]))
        assert min(n_ for _, n_ in spans) >= 1
    assert plan.chunks == -(-B // plan.chunk) and 1 <= plan.chunk <= B
    assert plan.tile == (max(n for _, n in ys), max(n for _, n in xs))
    ty, tx = plan.tile
    assert ty <= V.VLASOV_MAX_ROWS
    assert plan.threads == plan.chunk * tx <= V.VLASOV_THREADS
    assert plan.smem_bytes == V.vlasov_smem_bytes(plan.tile, plan.chunk) <= smem
    assert plan.vec in (1, 4) and B % plan.vec == 0 and plan.chunk % plan.vec == 0
    assert plan.vec == 4 or B % 4 or plan.chunk % 4
    assert plan.ctas == D * plan.z_parts * n_ty * n_tx * plan.chunks < 2 ** 31
    # one wave: the z runs add CTAs only while every SM holds them
    assert plan.z_parts == 1 or plan.ctas <= V.VLASOV_CTAS_PER_SM * sms


MAIN = (1, 32, 32, 32, 512)


def test_main_path_plan():
    """The bench's 32^3 x 512 phase space: 16 x 16 tiles of 16 bins, 2 z
    runs, 256 CTAs of 256 threads, 16-byte copies, f read once from device
    memory and held only in the plane windows."""
    plan = V.vlasov_step_plan(*MAIN, SMS, SMEM)
    _check_plan(MAIN, plan)
    assert (plan.tile, plan.chunk, plan.z_parts, plan.ctas, plan.threads, plan.vec) == \
        ((16, 16), 16, 2, 256, 256, 4)
    assert plan.l2 == () and plan.shared == ("f plane windows",)


SHAPES = [MAIN, (2, 16, 32, 32, 512), (1, 8, 16, 12, 512), (2, 4, 8, 8, 27),
          (1, 6, 5, 7, 64), (1, 4, 3, 2, 1), (1, 8, 8, 8, 125), (3, 2, 1, 100, 8),
          (1, 2, 257, 33, 64), (5, 4, 40, 40, 343)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_tiles_and_fits(shape):
    _check_plan(shape, V.vlasov_step_plan(*shape, SMS, SMEM))


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(D=st.integers(1, 8), nzl=st.sampled_from([2, 4, 6, 8, 12, 16, 64, 256]),
       ny=st.integers(1, 300), nx=st.integers(1, 300), nv=st.integers(1, 12),
       sms=st.sampled_from([1, 8, 132]))
def test_plan_fits_every_admitted_shape(D, nzl, ny, nx, nv, sms):
    """Every shape the dispatch admits (a z block of 2, 4 or 8 fits the JAX
    package's budget) has a plan, on cards of 1 to 132 SMs."""
    B = nv ** 3
    if not V.pick_vlasov_block(nzl, ny, nx, B):
        return
    shape = (D, nzl, ny, nx, B)
    _check_plan(shape, V.vlasov_step_plan(*shape, sms, SMEM), sms=sms)


def test_largest_admitted_plane():
    """The largest plane pick_vlasov_block admits at 512 bins."""
    ny = 32
    nx = V._VLASOV_VMEM_BUDGET // 24 // (ny * 512 * 4)
    assert V.pick_vlasov_block(2, ny, nx, 512) and not V.pick_vlasov_block(2, ny, nx + 1, 512)
    shape = (1, 2, ny, nx, 512)
    _check_plan(shape, V.vlasov_step_plan(*shape, SMS, SMEM))


@pytest.mark.parametrize("args", [(1, 32, 32, 32, 512, 132, 1000),
                                  (1, 8, 8, 8, 27, 132, 100)], ids=["512-bins", "27-bins"])
def test_plan_refuses_what_does_not_fit(args):
    with pytest.raises(ValueError, match="no tile of"):
        V.vlasov_step_plan(*args)


def test_plan_halves_the_tile_to_fit():
    """Where the 16 x 16 tile's windows do not fit, the plan halves it."""
    small = V.vlasov_smem_bytes((16, 16), 16) - 1
    plan = V.vlasov_step_plan(*MAIN, SMS, small)
    _check_plan(MAIN, plan, smem=small)
    assert plan.tile[0] * plan.tile[1] < 256


@pytest.mark.parametrize("value,pattern", [
    (V.VLASOV_THREADS, r"constexpr int kThreads = (\d+);"),
    (V.VLASOV_MAX_ROWS, r"constexpr int kMaxRows = (\d+);"),
    (V.VLASOV_STAGES, r"constexpr int kStages = (\d+);"),
    (V.VLASOV_CTAS_PER_SM, r"constexpr int kMinCtas = (\d+);"),
], ids=["kThreads", "kMaxRows", "kStages", "kMinCtas"])
def test_plan_constants_match_the_kernel(value, pattern):
    src = (CSRC / "vlasov.cu").read_text()
    assert re.findall(pattern, src) == [str(value)]
    assert src.count("__launch_bounds__(kThreads, kMinCtas)") == 1


# ------------------------------------------------------------ the identity

def _split_up(f, up, pos, v, s):
    """A split reading only the upwind neighbour: the kernel's split_up."""
    ff, fu = f * v, up * v
    return f - s * torch.where(pos, ff - fu, fu - ff)


def emulate_vlasov(plan, f, edge_lo, edge_hi, vx, vy, vz, dt, inv_dx, periodic):
    """B7's tile scheme on the CPU: for each CTA (slab, z run, tile, bin
    chunk) and each of its planes z0-1 .. z0+zl, the wrapped window, its
    rows' x split at the tile's columns, the y split, and the z split of
    the plane below from the two before it.  Edge planes None: the planes
    beyond a slab's ends are the neighbouring slabs' (vacuum past an open z
    end), as the kernel reads them from f."""
    D, nzl, ny, nx, B = f.shape
    sx, sy, sz = V.split_scales(dt, inv_dx, f.dtype)
    px, py, pz = (bool(p) for p in periodic[:3])
    out = torch.full_like(f, float("nan"))
    for d in range(D):
        def plane(z):
            if 0 <= z < nzl:
                return f[d, z]
            if edge_lo is not None:
                return edge_lo[d, 0] if z < 0 else edge_hi[d, 0]
            if not pz and (d == 0 if z < 0 else d == D - 1):
                return torch.zeros_like(f[d, 0])
            return f[(d - 1) % D, nzl - 1] if z < 0 else f[(d + 1) % D, 0]
        for z0, zl in (R.part(nzl, plan.z_parts, i) for i in range(plan.z_parts)):
            for y0, h in (R.part(ny, plan.tiles[0], i) for i in range(plan.tiles[0])):
                for x0, w in (R.part(nx, plan.tiles[1], i) for i in range(plan.tiles[1])):
                    for b0 in range(0, B, plan.chunk):
                        bs = slice(b0, min(B, b0 + plan.chunk))
                        rows = torch.arange(y0 - 1, y0 + h + 1) % ny
                        cols = torch.arange(x0 - 1, x0 + w + 1) % nx
                        gx = torch.arange(x0, x0 + w)
                        gy = torch.arange(y0, y0 + h)
                        v_x, v_y, v_z = vx[bs], vy[bs], vz[bs]
                        px_, py_, pz_ = v_x >= 0, v_y >= 0, v_z >= 0
                        has_x = torch.where(px_, (gx != 0)[:, None], (gx != nx - 1)[:, None]) | px
                        has_y = torch.where(py_, (gy != 0)[:, None], (gy != ny - 1)[:, None]) | py
                        g = []
                        for z in range(z0 - 1, z0 + zl + 1):
                            win = plane(z)[rows][:, cols][:, :, bs]       # [h+2, w+2, C]
                            up = torch.where(px_, win[:, :-2], win[:, 2:])
                            xs = _split_up(win[:, 1:-1], torch.where(has_x, up, 0.0),
                                           px_, v_x, sx)                 # [h+2, w, C]
                            upy = torch.where(py_, xs[:-2], xs[2:])
                            g.append(_split_up(xs[1:-1], torch.where(has_y[:, None], upy, 0.0),
                                               py_, v_y, sy))            # [h, w, C]
                            if len(g) == 3:
                                dn, c, upz = g
                                out[d, z - 1, y0:y0 + h, x0:x0 + w, bs] = _split_up(
                                    c, torch.where(pz_, dn, upz), pz_, v_z, sz)
                                g.pop(0)
    return out


def _inputs(D, nzl, ny, nx, B, periodic, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    f = r.uniform(0.0, 1.0, (D, nzl, ny, nx, B))
    lo, hi = np.roll(f[:, -1:], 1, axis=0), np.roll(f[:, :1], -1, axis=0)
    if not periodic[2]:
        lo[0] = 0.0
        hi[-1] = 0.0
    v = r.uniform(-1.0, 1.0, (3, B))
    inv_dx = np.array([nx, ny, D * nzl], np.float64)
    dt = float(np.float32(0.4 / max(nx, ny, D * nzl)))
    return (t(f), t(lo), t(hi), t(v[0]), t(v[1]), t(v[2]), dt), inv_dx


@pytest.mark.parametrize("shape,periodic,sms,smem,ring", [
    ((1, 8, 8, 8, 64), (True, True, True), 132, SMEM, False),
    ((2, 4, 7, 9, 27), (True, False, False), 4, SMEM, True),
    ((1, 6, 5, 3, 8), (False, True, True), 1, SMEM, False),
    ((2, 3, 4, 5, 1), (False, False, True), 16, SMEM, True),
    ((1, 4, 16, 16, 40), (True, True, False), 3, 20_000, False),
], ids=["64-bins", "27-bins-open-yz", "one-sm", "one-bin-open-xy", "ragged-small-tiles"])
def test_tile_scheme_equals_twin(shape, periodic, sms, smem, ring):
    """The tile scheme on plans with several tiles, chunks and z runs (and
    a shared-memory limit that halves the tile), its edge planes given or
    read from the slab ring, equals the twin bitwise."""
    args, inv_dx = _inputs(*shape, periodic, seed=sum(shape))
    if ring:
        args = (args[0], None, None, *args[3:])
    plan = V.vlasov_step_plan(*shape, sms, smem)
    assert plan.tiles != (1, 1) or plan.chunks > 1 or plan.z_parts > 1
    want = V.vlasov_step_blocked_plain(*args, block=2, inv_dx=inv_dx, periodic=periodic)
    got = emulate_vlasov(plan, *args, inv_dx, periodic)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tile_scheme_main_plan_on_a_small_slab():
    """The main path's plan (16 x 16 tiles of 16 bins) on a 16^3 x 64 slab
    that it cuts the same way (tiles of whole 16-cell extents)."""
    shape = (1, 16, 16, 16, 64)
    args, inv_dx = _inputs(*shape, (True, True, True), seed=3)
    plan = V.vlasov_step_plan(*shape, SMS, SMEM)
    assert plan.tile == (16, 16) and plan.chunk == 16
    want = V.vlasov_step_blocked_plain(*args, block=4, inv_dx=inv_dx,
                                       periodic=(True, True, True))
    assert torch.equal(emulate_vlasov(plan, *args, inv_dx, (True, True, True)), want)


@pytest.mark.parametrize("periodic", [(True, True, True), (False, False, False)],
                         ids=["periodic", "open"])
def test_tile_scheme_matches_pallas(periodic):
    """The emulation against ``make_vlasov_step_blocked(..., interpret=True)``
    per slab, at the twin's 4-ULP envelope."""
    shape = (2, 8, 8, 8, 27)
    (f, lo, hi, vx, vy, vz, dt), inv_dx = _inputs(*shape, periodic, seed=11)
    plan = V.vlasov_step_plan(*shape, 4, SMEM)
    got = emulate_vlasov(plan, f, lo, hi, vx, vy, vz, dt, inv_dx, periodic).numpy()
    step = make_vlasov_step_blocked(8, 8, 8, 27, inv_dx, periodic, block=4, interpret=True)
    vj = [jnp.asarray(v.numpy()).reshape(1, 1, 1, 27) for v in (vx, vy, vz)]
    want = np.stack([np.asarray(step(f[d].numpy(), lo[d].numpy(), hi[d].numpy(), *vj, dt))
                     for d in range(2)])
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert not (np.abs(got - want) > 4 * ulp).any()


@pytest.mark.parametrize("D,periodic_z", [(1, True), (3, True), (3, False), (1, False)])
def test_ring_edges_are_the_slab_ring(D, periodic_z):
    """Edge planes None: the wrapper (its twin here) takes the slab ring's
    planes, as the kernel reads them from f — the neighbouring slabs' end
    planes, vacuum past an open z end — and equals the step given them
    explicitly, as the model made them (``HaloExtend.planes`` masked)."""
    periodic = (True, False, periodic_z)
    (f, lo, hi, vx, vy, vz, dt), inv_dx = _inputs(D, 4, 5, 6, 8, periodic, seed=D)
    kw = dict(block=2, inv_dx=inv_dx, periodic=periodic)
    ring = V.vlasov_step(f, None, None, vx, vy, vz, dt, **kw)
    assert torch.equal(ring, V.vlasov_step(f, lo, hi, vx, vy, vz, dt, **kw))
    r_lo, r_hi = V.ring_edges(f, periodic_z)
    assert torch.equal(r_lo, lo) and torch.equal(r_hi, hi)
    if not periodic_z:
        assert not r_lo[0].any() and not r_hi[-1].any()
