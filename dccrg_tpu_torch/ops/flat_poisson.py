"""Dense flat-voxel Poisson matvec: the BiCG operator on uniform and
refined Cartesian grids without gathers.

The general Poisson path applies A (and Aᵀ) through per-row gather tables
(``models/poisson.py``).  This module re-expresses the matvec on the flat
inflated voxel grid of ``ops/flat_amr.py`` (every leaf either is a
finest-level voxel or is replicated over its cube of them): neighbor access
is six rolls and coarse-row accumulation is a pool/broadcast over each
coarse leaf's block.

Semantics (reference ``tests/poisson/poisson_solve.hpp``), as in the JAX
package's ``ops/flat_poisson.py``:

* per-face factors ``f_side`` from cell-center offsets with missing or
  inactive neighbors giving 0 (``poisson_solve.hpp:691-822``), taken from
  the leaf-level arrays the model computes;
* a finer face neighbor's contribution divided by 4
  (``poisson_solve.hpp:332-336``): a level-l leaf's face spans
  ``4^(vl-l)`` voxel sub-faces, so its per-voxel weight is ``f/4^(vl-l)``
  and the block sum restores the reference's factor;
* skip cells act as missing neighbors and boundary-boundary pairs are
  dropped (``poisson_solve.hpp:896-965``), folded into the face weights;
* ``A = S·C·E`` (E replicates leaves onto voxels, S = Eᵀ sums a block, C
  is the voxel face operator), so ``Aᵀ = S·Cᵀ·E`` and ``Cᵀ`` is the same
  six weights applied with reversed rolls.

:func:`build_flat_poisson` is a copy of the JAX package's host builder.
:func:`make_flat_poisson_apply` is the torch form of its operator.  With D
device slots the voxel grid is still the whole ``[nz, ny, nx]`` array (the
slots are z-slabs of it): the z-rolls cross the slabs by themselves.
Under several controllers (``parallel/mesh.py``) a controller holds its own
block of z-slabs, ``[len(slots) * nzl, ny, nx]``, exactly its slice of the
one-controller array: the z-rolls roll the block and take its two end
planes from the neighbouring controllers over the slab ring
(``parallel/dense.py::HaloExtend.cross``, one transport batch a matvec),
circular even where z is open (the one-controller roll wraps too and the
weights zero the wrapped face).  The coarse pooling runs slot by slot on
any slot count: coarse blocks never straddle slabs, so a slot's own roll
chain is the whole array's up to the sign of zero, and every controller
layout of the same slots computes the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_flat_poisson", "make_flat_poisson_apply", "roll_apply",
           "pool_two_level"]

#: the JAX package's device-memory cap: the solver keeps ~10 voxel arrays
_MAX_VOXELS = 1 << 24


def build_flat_poisson(grid, f_pos, f_neg, scaling_leaf, types_leaf,
                       solve_code, skip_code, boundary_code):
    """Static tables for the flat Poisson operator, or None if the grid
    does not qualify.

    ``f_pos``/``f_neg``: (N, 3) per-leaf per-axis side factors;
    ``scaling_leaf``: (N,) diagonal; ``types_leaf``: (N,) cell roles.
    """
    from .flat_amr import _ML_MAX_VL, flat_voxel_layout

    lay = flat_voxel_layout(
        grid, allow_uniform=True, max_voxels=_MAX_VOXELS,
        allow_multi_device=True, max_vl=_ML_MAX_VL,
    )
    if lay is None:
        return None
    shape = lay["shape"]
    leaf_idx = lay["leaf_idx"]
    vl = int(lay["vox_level"])

    t_vox = np.asarray(types_leaf)[leaf_idx]
    f_pos_vox = np.asarray(f_pos)[leaf_idx]        # (n_vox, 3)
    f_neg_vox = np.asarray(f_neg)[leaf_idx]
    scaling_vox = np.asarray(scaling_leaf)[leaf_idx]

    nz1, ny1, nx1 = shape
    rows3 = leaf_idx.reshape(shape)   # same-leaf face detection
    fine3 = lay["leaf_fine"]
    lev3 = lay["leaf_level"]
    t3 = t_vox.reshape(shape)
    # a level-l leaf's face spans 4^(vl-l) voxel sub-faces, so its
    # per-voxel face weight is f / 4^(vl-l) and the leaf-block sum
    # restores exactly the reference's factors: full f toward same or
    # coarser neighbors, f/4 toward each finer face neighbor
    # (poisson_solve.hpp:332-336) — at any level spread (2:1 balance
    # keeps adjacent leaves within one level)
    sub = 0.25 ** (vl - lev3).astype(np.float64)

    def active(ta, tb):
        return (
            (ta != skip_code)
            & (tb != skip_code)
            & ~((ta == boundary_code) & (tb == boundary_code))
        )

    weights = []
    for d, ax in ((0, 2), (1, 1), (2, 0)):
        fp = f_pos_vox[:, d].reshape(shape)
        fn = f_neg_vox[:, d].reshape(shape)
        rb_p = np.roll(rows3, -1, ax)
        rb_n = np.roll(rows3, 1, ax)
        # same-row faces are interior to a coarse block (no leaf face
        # there) and must drop — EXCEPT when the roll wrapped around a
        # periodic axis back into the same leaf (domain extent of one
        # leaf along the axis): that is the leaf's genuine periodic face
        # and the reference couples the cell to itself through it.
        # Non-periodic domain edges are harmless to keep: their factors
        # are already 0.
        pos = np.arange(shape[ax])
        at_max = (pos == shape[ax] - 1).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        at_min = (pos == 0).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        wp = fp * sub * active(t3, np.roll(t3, -1, ax)) * (
            (rows3 != rb_p) | at_max
        )
        wn = fn * sub * active(t3, np.roll(t3, 1, ax)) * (
            (rows3 != rb_n) | at_min
        )
        weights.append((wp, wn))

    ex = (np.arange(nx1) % 2 == 0)[None, None, :]
    ey = (np.arange(ny1) % 2 == 0)[None, :, None]
    ez = (np.arange(nz1) % 2 == 0)[:, None, None]
    orig = ex & ey & ez
    solve3 = t3 == solve_code

    # leaf-origin mask: the one voxel per leaf whose coordinates are
    # aligned to ITS leaf's block size — the generalized "each leaf
    # counted once" selector for dots and writeback at any level spread
    zi, yi, xi = np.meshgrid(np.arange(nz1), np.arange(ny1),
                             np.arange(nx1), indexing="ij")
    B3 = 1 << (vl - lev3)
    leaf_origin = ((zi % B3 == 0) & (yi % B3 == 0) & (xi % B3 == 0))

    # multi-level accumulation tables (reshape pyramid): per-doubling
    # capture masks at their own reduced resolution; 2-level grids keep
    # the roll-chain (these stay unused there)
    cap_masks, cap_active = [], []
    for k in range(vl):
        f = 1 << (k + 1)
        lev_red = lev3[::f, ::f, ::f]
        m = (lev_red == vl - 1 - k)
        cap_masks.append(m.astype(np.float64))
        cap_active.append(bool(m.any()))

    return dict(
        shape=shape,
        n_devices=lay["n_devices"],
        vl=vl,
        rows=lay["rows"],
        fine=fine3,
        has_coarse=bool((~fine3).any()),
        weights=weights,
        scaling=scaling_vox.reshape(shape),
        solve=solve3,
        # dot weights: each leaf counted once at its own origin voxel
        dot_mask=solve3 & leaf_origin,
        orig=orig,
        cap_masks=cap_masks,
        cap_active=cap_active,
        wb_rows=lay["wb_rows"],
        wb_valid=lay["wb_valid"],
    )


def roll_apply(v, W, scaling, accumulate, transpose, cross=None):
    """``scaling·v + accumulate(C)`` on a voxel array, C the six face terms:
    per axis x, y, z ``wp·v[+1] + wn·v[-1]``, or with ``transpose`` the same
    weights with reversed rolls, ``(wp·v)[-1] + (wn·v)[+1]`` (Cᵀ).  ``W``
    holds the ``(wp, wn)`` pairs in x, y, z order; ``accumulate`` maps the
    per-voxel face sums to leaf-row totals.  Terms add left to right, as
    the JAX package's body and the whole-solve kernel add them (its start
    from zeros differs only in the sign of zero).

    ``cross``: where ``v`` is one controller's block of z-slabs, the slab
    ring's crossing (``HaloExtend.cross``): the two z-rolls then take their
    end planes from the neighbouring controllers, ``v``'s own for A·v and
    ``wp·v`` / ``wn·v``'s for Aᵀ·v, in one exchange."""
    C = None
    for (wp, wn), ax in zip(W, (2, 1, 0)):
        if transpose:
            pv, nv = wp * v, wn * v
            a, b = torch.roll(pv, 1, ax), torch.roll(nv, -1, ax)
            if ax == 0 and cross is not None:
                a[0], b[-1] = cross(pv[-1], nv[0])
        else:
            a, b = torch.roll(v, -1, ax), torch.roll(v, 1, ax)
            if ax == 0 and cross is not None:
                b[0], a[-1] = cross(v[-1], v[0])
            a, b = wp * a, wn * b
        C = a + b if C is None else C + a + b
    return scaling * v + accumulate(C)


def pool_two_level(C, coarse, orig, fine):
    """Leaf-row totals of a two-level grid from per-voxel face
    contributions: fine voxels keep theirs; coarse blocks pool (the
    even-aligned -1-roll chain, x then y then z), park the total at the
    block origin, then broadcast it back over the block.  The wrap planes
    only land on positions the orig/odd masking zeroes (blocks are
    2-aligned), so the chain is exact on the whole array, and on each slot's
    slab of a ``[S, nzl, ny, nx]`` stack (the rolls take the last three
    axes)."""
    s = C * coarse
    s = s + torch.roll(s, -1, -1)
    s = s + torch.roll(s, -1, -2)
    s = s + torch.roll(s, -1, -3)
    s = s * orig
    s = s + torch.roll(s, 1, -1)
    s = s + torch.roll(s, 1, -2)
    s = s + torch.roll(s, 1, -3)
    return fine * C + s


def _down2(a):
    nz, ny, nx = a.shape
    return a.reshape(nz // 2, 2, ny // 2, 2, nx // 2, 2).sum(dim=(1, 3, 5))


def _up2(a):
    nz, ny, nx = a.shape
    return a[:, None, :, None, :, None].expand(nz, 2, ny, 2, nx, 2).reshape(
        nz * 2, ny * 2, nx * 2)


def make_flat_poisson_apply(tables, dtype, device, slots=None, ring=None):
    """Returns ``(apply_fwd, apply_rev, voxelize, writeback, masks)``.

    ``apply_*`` map a voxel array to A·v / Aᵀ·v in voxel layout (coarse
    rows' results replicated over their blocks).  ``voxelize`` lifts a
    ``[D, R]`` row array onto the voxel grid; ``writeback`` projects a
    voxel array onto ``[D, R]`` rows.  ``masks`` holds the ``solve`` and
    ``dot`` voxel masks (bool).

    ``slots``: this controller's block of the D slots (a ``range``; default
    all of them): the voxel arrays are its z-slabs ``[len(slots) * nzl, ny,
    nx]`` and the rows its ``[len(slots), R]``.  ``ring``: the controllers'
    slab ring (a ``HaloExtend`` over D slots) whose crossing feeds the
    z-rolls' end planes; None on one controller."""
    D = tables["n_devices"]
    slots = range(D) if slots is None else slots
    nz, ny, nx = (int(v) for v in tables["shape"])
    nzl, Dl = nz // D, len(slots)
    shape = (Dl * nzl, ny, nx)
    z0, z1 = slots.start * nzl, slots.stop * nzl
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
    # this controller's z-slabs of a whole-grid voxel array
    loc = lambda a, dt: put(np.asarray(a)[z0:z1], dt)
    fine_f = loc(tables["fine"], dtype)
    coarse_f = loc(~tables["fine"], dtype)
    orig_f = loc(tables["orig"], dtype)
    scaling = loc(tables["scaling"], dtype)
    W = [(loc(wp, dtype), loc(wn, dtype)) for wp, wn in tables["weights"]]
    has_coarse = tables["has_coarse"]
    vl = int(tables.get("vl", 1))
    cap_active = tables.get("cap_active") or []
    kmax = max((k for k in range(len(cap_active)) if cap_active[k]),
               default=-1)
    # the capture masks at their doubling's resolution: slabs hold whole
    # coarse blocks, so the block's slice is z0 / f .. z1 / f
    caps = [put(np.asarray(m)[z0 >> (k + 1):z1 >> (k + 1)], dtype)
            for k, m in enumerate(tables.get("cap_masks") or [])]
    cross = None if ring is None else ring.cross
    # the two-level pooling runs slot by slot (``pool_two_level``)
    slabs = (Dl, nzl, ny, nx)
    fine_s, coarse_s, orig_s = (a.view(slabs) for a in (fine_f, coarse_f, orig_f))

    def accum_ml(C):
        """Multi-level leaf-row totals: the reshape pyramid (plain block
        sums — the Poisson S operator is a SUM), captured per doubling at
        the level's own resolution and broadcast back up."""
        cur = C * coarse_f
        subs = []
        for _k in range(kmax + 1):
            cur = _down2(cur)
            subs.append(cur)
        acc = None
        for k in range(kmax, -1, -1):
            if acc is not None:
                acc = _up2(acc)
            if cap_active[k]:
                contrib = subs[k] * caps[k]
                acc = contrib if acc is None else acc + contrib
        out = fine_f * C
        if acc is not None:
            out = out + _up2(acc)
        return out

    def accumulate(C):
        if not has_coarse:
            return C
        if vl >= 2:
            return accum_ml(C)
        if D == 1:
            return pool_two_level(C, coarse_f, orig_f, fine_f)
        return pool_two_level(C.view(slabs), coarse_s, orig_s,
                              fine_s).view(shape)

    def apply_fwd(v):
        return roll_apply(v, W, scaling, accumulate, False, cross)

    def apply_rev(v):
        return roll_apply(v, W, scaling, accumulate, True, cross)

    # one path for any D: rows [D, n_loc] (slot d's z-slab voxels, slabs in
    # slot order along z) and wb_rows [D, R] (slab-local flat voxels), this
    # controller's slots of them
    sl = slice(slots.start, slots.stop)
    rows = put(np.asarray(tables["rows"]).reshape(D, -1)[sl], torch.int64)
    wb_rows = put(np.asarray(tables["wb_rows"]).reshape(D, -1)[sl], torch.int64)
    wb_valid = put(np.asarray(tables["wb_valid"]).reshape(D, -1)[sl], torch.bool)
    slot = torch.arange(Dl, device=device)[:, None]

    def voxelize(row_arr):
        return row_arr[slot, rows].reshape(shape).to(dtype)

    def writeback(vox_arr):
        flat = vox_arr.reshape(Dl, -1)
        zero = torch.zeros((), dtype=vox_arr.dtype, device=vox_arr.device)
        return torch.where(wb_valid, torch.gather(flat, 1, wb_rows), zero)

    masks = dict(solve=loc(tables["solve"], torch.bool),
                 dot=loc(tables["dot_mask"], torch.bool))
    return apply_fwd, apply_rev, voxelize, writeback, masks
