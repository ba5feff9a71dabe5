"""The whole-solve BiCG kernel's twin (``ops/poisson_kernel.py``) against the
JAX package's Pallas kernel ``make_bicg_solve`` in interpret mode, on the same
float32 voxel arrays built by the JAX package's flat Poisson tables (12^3
level-0 cells, uniform and with a refined ball).

Tolerances are test_poisson.py::test_fused_bicg_matches_xla_flat's:
iterations within 1; with equal iterations the best residual at rel 1e-5
and the solution at rtol 1e-5 / atol 1e-7.  The two differ in dot
association only (the twin's dots are the CUDA kernel's blocked order), so
the inputs are a seeded random rhs: the bench's sin·cos rhs is an
eigenvector of the uniform operator, whose solve reaches rounding level in
one iteration, where the iteration count is decided by rounding noise.

The reduction order itself is held against a loop-by-loop numpy
reimplementation of the kernel's trees, so the twin the card compares the
kernel with is the documented order.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dccrg_tpu
from dccrg_tpu.models import Poisson as JPoisson
from dccrg_tpu.ops import poisson_kernel as jk
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
from dccrg_tpu_torch.ops import poisson_kernel as tk


@functools.lru_cache(maxsize=None)
def _inputs(refine, rhs_kind="random"):
    """(14 float32 numpy arrays, has_coarse): the JAX model's fused-solve
    operands for a 12^3 grid."""
    n = 12
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
    ids = g.get_cells()
    c = g.geometry.get_center(ids)
    rhs = {"random": np.random.default_rng(5).standard_normal(len(ids)),
           "sincos": np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1]),
           "zero": np.zeros(len(ids))}[rhs_kind]
    s = p.initialize_state(rhs)
    _f, _r, vox, _wb, masks = p._flat
    f32 = lambda a: np.asarray(a, np.float32)
    arrays = ([f32(jnp.where(masks["solve"], vox(s["rhs"]), 0.0)),
               f32(vox(s["solution"]))]
              + [f32(w) for pair in t["weights"] for w in pair]
              + [f32(a) for a in (t["scaling"], t["fine"], ~t["fine"], t["orig"],
                                  t["solve"], t["dot_mask"])])
    return tuple(arrays), bool(t["has_coarse"])


def _both(arrays, has_coarse, *scalars):
    kern = jk.make_bicg_solve(arrays[0].shape, has_coarse, interpret=True)
    jx, jr, ji = kern(*[jnp.asarray(a) for a in arrays], *scalars)
    tx, tr, ti = tk.bicg_solve_plain(*[torch.tensor(a) for a in arrays],
                                     *scalars, has_coarse=has_coarse)
    return ((np.asarray(jx), float(jr[0]), int(ji[0])),
            (tx.numpy(), float(tr[0]), int(ti[0])))


def _agree(j, t, stop_res):
    """test_fused_bicg_matches_xla_flat's comparison."""
    (jx, jr, ji), (tx, tr, ti) = j, t
    assert abs(ji - ti) <= 1
    if ji == ti:
        assert tr == pytest.approx(jr, rel=1e-5)
        np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-7)
    else:
        assert jr <= stop_res and tr <= stop_res
        np.testing.assert_allclose(tx, jx, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("refine,stop_res", [(False, 1e-3), (True, 1e-5)])
def test_twin_matches_pallas_interpret(refine, stop_res):
    arrays, hc = _inputs(refine)
    assert hc == refine
    j, t = _both(arrays, hc, 60, stop_res, 10.0)
    _agree(j, t, stop_res)
    assert t[2] > 10


def test_stops_at_the_residual_target():
    arrays, hc = _inputs(False)
    j, t = _both(arrays, hc, 60, 1e-3, 10.0)
    assert t[2] < 60 and t[1] <= 1e-3 < np.sqrt(np.sum(arrays[0].astype(np.float64) ** 2))
    _agree(j, t, 1e-3)


def test_zero_rhs_breaks_down_after_zero_iterations():
    """rhs = 0 from x0 = 0: dot_r == 0 at the start, so no iteration runs
    and the initial guess comes back."""
    arrays, hc = _inputs(True, "zero")
    assert not arrays[0].any() and not arrays[1].any()
    j, t = _both(arrays, hc, 60, 0.0, 10.0)
    assert j[1:] == t[1:] == (0.0, 0)
    np.testing.assert_array_equal(t[0], arrays[1])


def test_semi_convergence_stop():
    """The refined grid's system is non-normal: with the bench's rhs BiCG
    stalls and the residual grows past 10x its best, which ends the solve
    early, far above the target, keeping the best solution."""
    arrays, hc = _inputs(True, "sincos")
    j, t = _both(arrays, hc, 60, 1e-5, 10.0)
    assert abs(j[2] - t[2]) <= 1 and t[2] < 60 and t[1] > 1e-5
    _, longer = _both(arrays, hc, 60, 1e-5, np.inf)
    assert longer[2] > t[2]


def test_bicg_fits_matches_jax():
    edge = jk._BICG_VMEM_BUDGET // (jk._BICG_ARRAYS * 4)
    for n in (1, 64 ** 3, edge, edge + 1, 1 << 24):
        assert tk.bicg_fits(n) == jk.bicg_fits(n)
    assert tk.bicg_fits(edge) and not tk.bicg_fits(edge + 1)


def test_cpu_wrapper_takes_the_twin():
    arrays, hc = _inputs(True)
    tensors = [torch.tensor(a) for a in arrays]
    reset_counts()
    got = tk.bicg_solve(*tensors, 5, 0.0, 10.0, has_coarse=hc)
    assert PLAIN_CALLS["bicg_solve"] == 1 and sum(LAUNCHES.values()) == 0
    want = tk.bicg_solve_plain(*tensors, 5, 0.0, 10.0, has_coarse=hc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.int32
    assert int(got[2][0]) == 5
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tk.bicg_solve(*tensors[:-1], tensors[-1].to("meta"), 5, 0.0, 10.0,
                      has_coarse=hc)


def _tree_np(v):
    """The kernel's in-block tree, one stride at a time, in float32."""
    v = np.array(v, np.float32)
    h = len(v) // 2
    while h >= 1:
        for t in range(h):
            v[t] = np.float32(v[t] + v[t + h])
        h //= 2
    return v[0]


def _blocked_np(items, tile=256):
    """The kernel's whole order: tile trees, then tile trees of the
    partials, zeros padding each level."""
    v = np.asarray(items, np.float32)
    while True:
        m = -(-len(v) // tile)
        v = np.concatenate([v, np.zeros(m * tile - len(v), np.float32)])
        v = np.array([_tree_np(v[j * tile:(j + 1) * tile]) for j in range(m)],
                     np.float32)
        if m == 1:
            return v[0]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70000])
def test_blocked_sum_is_the_kernel_order(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tk.blocked_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and float(got) == float(_blocked_np(x))


def test_blocked_dot_groups_coarse_blocks():
    """With has_coarse, an item is a 2x2x2 block: its 8 masked products
    (e = dz*4 + dy*2 + dx) as a tree at strides 4, 2, 1, items in block
    order."""
    rng = np.random.default_rng(3)
    shape = (4, 6, 8)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = (rng.random(shape) < 0.7).astype(np.float32)
    w = np.where(m != 0, a * b, np.float32(0.0)).astype(np.float32)
    items = [_tree_np([w[z + e // 4, y + (e // 2) % 2, x + e % 2] for e in range(8)])
             for z in range(0, 4, 2) for y in range(0, 6, 2) for x in range(0, 8, 2)]
    got = tk.blocked_dot(*(torch.from_numpy(v) for v in (a, b, m)), True)
    assert float(got) == float(_blocked_np(items))
    got1 = tk.blocked_dot(*(torch.from_numpy(v) for v in (a, b, m)), False)
    assert float(got1) == float(_blocked_np(w.reshape(-1)))
