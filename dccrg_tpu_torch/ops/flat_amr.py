"""Flat inflated-voxel AMR advection: host tables, face weights, and the two
whole-run CUDA kernels with their plain PyTorch twins.

Scheme (the JAX package's ``ops/flat_amr.py``): replicate every leaf onto
its cube of finest-level voxels, giving one dense array ``V`` over the whole
domain at the finest resolution.  Every face the reference prices
(``solve.hpp:129-260``) is then a voxel pair of ``V`` with the reference's
length-weighted face velocity; with ``w+ = w·[v_face >= 0]`` and
``w- = w·[v_face < 0]`` precomputed per voxel face,
``F = V·w+ + roll(V,-1)·w-``.  A coarse leaf's update is the block sum of
its voxels' deltas over its own volume, broadcast back over the block.
Periodic boundaries are the rolls themselves; non-periodic wrap faces carry
weight 0.

Two hand-written kernels (``csrc/flat_amr.cu``) run a whole ``run`` in one
cooperative launch each:

==========================  ==============================================
wrapper                     replaces (``dccrg_tpu/ops/flat_amr.py``)
==========================  ==============================================
:func:`flat_amr_run`        ``make_flat_amr_run`` (leaf levels {0, 1})
:func:`flat_ml_run`         ``make_flat_ml_run_pallas`` (3 or more levels)
==========================  ==============================================

Each wrapper premultiplies ``dt`` into the six face weights with a torch
multiply, then launches its kernel on CUDA tensors (or raises) and takes its
plain twin (``*_plain``, the same premultiply, then ``torch.roll``) only on
CPU tensors.  The kernels keep the twins' association order, so the two
agree bitwise on the card (up to the sign of zero).

Both kernels hold their grid on chip for the whole run: one CTA a brick,
cut by a pure-Python launch plan (:func:`flat_amr_run_plan`,
:func:`flat_ml_run_plan`) that the wrapper passes to the kernel.  The plan
says where each array lives: the density box in shared memory always, the
six face weights there when they fit beside it (else read from L2 each
step), the per-voxel masks and new values of a thread's 2x2x2 units in
registers.

The JAX kernels take an optional lane padding of the x extent
(``pad_lane_extent`` / ``nx_pad``) that aligns the TPU's 128-lane rolls; by
its own contract the padded form is bit-identical to the unpadded one, and
this card has no lanes to align, so the wrappers take unpadded arrays only.

The fit rules (``flat_amr_fits``, ``flat_ml_kernel_fits``) and the layout
cost guards are copied from the JAX package, so both packages pick the same
path; they model the TPU's on-chip memory, not this card's.

The JAX package's two XLA forms of the scheme (XLA programs, no Pallas
kernel) are plain torch here, over the port's leading slot axis:
:func:`make_flat_amr_run_sharded` (levels {0, 1}, the voxel domain z-slab
sharded over D > 1 slots, tables from :func:`build_flat_amr_sharded`) and
:func:`make_flat_ml_run` (3 or more levels, any slot count, any float
dtype: the multi-level reshape pyramid).  Their per-step z halo is the
dense path's slot ring (``parallel/dense.HaloExtend``).  The face weights
of both forms round in the run's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.registry import metrics as _metrics
from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _f32, _launched, _on_cpu
from .resident import RUN_THREADS, card_limits, cuts

__all__ = [
    "flat_amr_fits",
    "flat_voxel_layout",
    "build_flat_amr_tables",
    "compute_flat_weights",
    "FlatRunPlan",
    "flat_amr_run_plan",
    "flat_ml_run_plan",
    "flat_amr_run",
    "flat_amr_run_plain",
    "build_flat_ml_tables",
    "compute_flat_ml_weights",
    "flat_ml_kernel_fits",
    "flat_ml_run",
    "flat_ml_run_plain",
    "build_flat_amr_sharded",
    "make_flat_amr_run_sharded",
    "make_flat_ml_run",
]

# ----------------------------------------------- dispatch thresholds (copied)

_FLAT_VMEM_BUDGET = 96 * 1024 * 1024
_FLAT_ARRAYS = 18


def flat_amr_fits(n_voxels: int) -> bool:
    return _FLAT_ARRAYS * n_voxels * 4 <= _FLAT_VMEM_BUDGET


def flat_ml_kernel_fits(n_voxels: int, vl: int) -> bool:
    """The multi-level kernel's rule: the 2-level kernel's ~18 resident
    arrays plus one capture mask per doubling."""
    return (_FLAT_ARRAYS + vl) * n_voxels * 4 <= _FLAT_VMEM_BUDGET


# ------------------------------------------------------------ launch plans

#: 2x2x2 units a thread of B5 / B6 holds in registers at most
#: (``kMaxUnits``)
FLAT_MAX_UNITS = 4
#: threads a CTA at most when each holds k units (``unit_threads(k)``):
#: fewer threads leave each more registers
FLAT_UNIT_THREADS = {1: 256, 2: 448, 3: 384, 4: 384}


@dataclass(frozen=True)
class FlatRunPlan:
    """How :func:`flat_amr_run`'s or :func:`flat_ml_run`'s kernel holds a
    ``[nz, ny, nx]`` voxel grid on chip: ``parts = (pz, py, px)`` bricks
    aligned to ``align`` voxels, one CTA of ``threads`` threads each,
    ``tile`` the largest brick ``(tz, ty, tx)``; each thread holds
    ``units_per_thread`` 2x2x2 units in registers (0: single voxels, two
    density boxes); ``smem_bytes`` the dynamic shared memory a CTA,
    ``face_floats`` one face slot of the global face buffer (2 x ctas x 6
    slots).  ``shared``, ``registers`` and ``l2`` name the arrays each
    place holds for the whole run."""

    parts: tuple
    tile: tuple
    align: int
    ctas: int
    threads: int
    units_per_thread: int
    weights_on_chip: bool
    smem_bytes: int
    face_floats: int
    shared: tuple
    registers: tuple
    l2: tuple


def flat_smem_bytes(tile, boxes: int, weights: bool, pool: int = 0,
                    halo: int = 0) -> int:
    """Shared memory of a brick ``tile = (tz, ty, tx)``: a pad float,
    ``boxes`` density boxes with a one-voxel halo on every face, the six
    face weights (each axis's pair with one plane on its minus side, x rows
    padded to ``tx + 2``, a pad float) when ``weights``, ``pool`` floats of
    pooling scratch, and the halo exchange's table (one int a cell of its
    ``halo`` and 12 face entries; ``layout_floats`` in the source).  The
    pads put a unit's voxel pairs on 8 bytes."""
    tz, ty, tx = tile
    n = 1 + boxes * (tz + 2) * (ty + 2) * (tx + 2) + pool + halo + 12
    if weights:
        n += 1 + 2 * (tz * ty * (tx + 2) + tz * (ty + 1) * tx + (tz + 1) * ty * tx)
    return 4 * n


def flat_pool_floats(tvox: int, kmax: int) -> int:
    """Pooling scratch of a brick of ``tvox`` voxels: one float a 4-cube
    for doubling 2, one an 8-cube for doubling 3 (``pool_floats``)."""
    return (tvox // 64 if kmax >= 2 else 0) + (tvox // 512 if kmax >= 3 else 0)


def flat_halo_cells(tile, parts) -> int:
    """Halo cells a brick reads from its neighbours a step: two planes on
    each axis cut into more than one part."""
    tz, ty, tx = tile
    sz, sy, sx = (p > 1 for p in parts)
    return 2 * (sx * tz * ty + sy * tz * tx + sz * ty * tx)


def _round_warp(n: int) -> int:
    return -(-n // 32) * 32


def _flat_plan(name, shape, align, kmax, sms, smem_per_block, registers):
    """The cut of ``shape`` into at most ``sms`` bricks aligned to
    ``align`` voxels that keeps the most on chip: the weights in shared
    memory if any cut allows it, then the fewest units a thread, the least
    shared memory, the widest x rows and the fewest CTAs.  ``kmax`` >= 0:
    2x2x2 units in registers; -1: single voxels, two boxes."""
    nz, ny, nx = shape
    if min(shape) < 1 or any(n % align for n in shape):
        raise ValueError(f"{name}: {nz}x{ny}x{nx} is not a grid of "
                         f"{align}-voxel cells")
    cells = (nz // align, ny // align, nx // align)
    best, least = None, None
    for parts in cuts(cells, sms):
        tile = tuple(-(-c // p) * align for c, p in zip(cells, parts))
        tvox = tile[0] * tile[1] * tile[2]
        if kmax >= 0:
            units = tvox // 8
            kb = next((k for k, n in FLAT_UNIT_THREADS.items() if units <= k * n), 0)
            if not kb:
                continue
            threads = _round_warp(-(-units // kb))
        else:
            kb, threads = 0, min(RUN_THREADS, _round_warp(tvox))
        for wsm in (True, False):
            smem = flat_smem_bytes(tile, 2 if kb == 0 else 1, wsm,
                                   flat_pool_floats(tvox, kmax),
                                   flat_halo_cells(tile, parts))
            least = smem if least is None else min(least, smem)
            if smem <= smem_per_block:
                key = (not wsm, kb, smem, -tile[2], parts[0] * parts[1] * parts[2])
                if best is None or key < best[0]:
                    best = (key, parts, tile, kb, threads, wsm, smem)
                break
    if best is None:
        raise ValueError(
            f"{name}: no cut of the {nz}x{ny}x{nx} grid into at most {sms} "
            f"bricks of {align}-voxel cells fits {smem_per_block} bytes of "
            f"shared memory a CTA and {FLAT_MAX_UNITS} units a thread ("
            + ("no cut holds its units" if least is None else
               f"the least shared memory any cut needs is {least}") + ")")
    (*_, ctas), parts, (tz, ty, tx), kb, threads, wsm, smem = best
    weights = ("wpx", "wnx", "wpy", "wny", "wpz", "wnz")
    shared = ("density" if kb else "density (two boxes)",) + (weights if wsm else ())
    return FlatRunPlan(
        parts=parts, tile=(tz, ty, tx), align=align, ctas=ctas, threads=threads,
        units_per_thread=kb, weights_on_chip=wsm, smem_bytes=smem,
        face_floats=max(tz * ty, tz * tx, ty * tx), shared=shared,
        registers=registers if kb else (),
        l2=(() if wsm else weights) + (() if kb else ("updf",)))


@functools.lru_cache(maxsize=256)
def flat_amr_run_plan(nz: int, ny: int, nx: int, sms: int,
                      smem_per_block: int) -> FlatRunPlan:
    """:func:`flat_amr_run`'s launch plan for a ``[nz, ny, nx]`` grid (even
    extents) on a card of ``sms`` SMs and ``smem_per_block`` bytes of
    opt-in shared memory a CTA.  Raises ``ValueError`` where none fits."""
    return _flat_plan("flat_amr_run_plan", (nz, ny, nx), 2, 0, sms,
                      smem_per_block, ("upd_f", "upd_c", "new density"))


@functools.lru_cache(maxsize=256)
def flat_ml_run_plan(nz: int, ny: int, nx: int, kmax: int, sms: int,
                     smem_per_block: int) -> FlatRunPlan:
    """:func:`flat_ml_run`'s launch plan: bricks aligned to the pooling
    cube of edge ``2^(kmax+1)``.  Raises ``ValueError`` where none fits."""
    return _flat_plan("flat_ml_run_plan", (nz, ny, nx), 1 << (kmax + 1), kmax,
                      sms, smem_per_block,
                      ("updf", "pool", "caps at unit origins", "new density"))


# ------------------------------------------------------------ host layout

def flat_voxel_layout(grid, allow_uniform=False, max_voxels=None,
                      allow_multi_device=False, max_vl=1):
    """The shared flat voxel layout, or None if the grid does not qualify
    (Cartesian, leaf levels ⊆ [0, max_vl], some refinement unless
    ``allow_uniform`` — the flat Poisson operator takes uniform grids, the
    flat advection runs do not; single device unless ``allow_multi_device``
    and the ownership equals the voxel z-slab partition with coarse blocks
    never straddling slabs).

    Returns a dict:
      shape        (nzv, nyv, nxv) voxel grid at max-leaf-level resolution
      vox_level    max leaf level (0 = uniform)
      n_devices    D
      leaf_idx     (n_vox,) int32 global leaf index per voxel (coarser
                   leaves replicated over their 2^d x 2^d x 2^d block)
      leaf_level   (nzv, nyv, nxv) int32 — owning leaf's refinement level
      leaf_fine    (nzv, nyv, nxv) bool — voxel is a max-level leaf
      rows         D == 1: (n_vox,) int32 epoch row per voxel;
                   D > 1:  (D, n_vox_loc) int32 per-device epoch rows of
                   the device's z-slab voxels
      wb_rows      D == 1: (R,) int32 — representative flat voxel per
                   epoch row (fine: its voxel; coarse: block origin);
                   D > 1: (D, R) slab-local flat voxel per row.  Scratch
                   and invalid rows point at voxel 0
      wb_valid     (R,) / (D, R) bool
    """
    epoch = grid.epoch
    D = epoch.n_devices
    if D != 1 and not allow_multi_device:
        return None
    if not getattr(grid.geometry, "uniform_level0", False):
        return None
    mapping = epoch.mapping
    leaves = epoch.leaves
    N = len(leaves)
    if N == 0:
        return None
    lvl = mapping.get_refinement_level(leaves.cells).astype(np.int64)
    vl = int(lvl.max())
    if vl > max_vl or (vl == 0 and not allow_uniform):
        return None
    L = mapping.max_refinement_level
    nxv, nyv, nzv = (int(v) << vl for v in mapping.length)
    n_vox = nxv * nyv * nzv
    if max_voxels is not None and n_vox > max_voxels:
        return None

    idx = mapping.get_indices(leaves.cells).astype(np.int64)  # (N,3) x,y,z
    vox = idx >> (L - vl)                # voxel-resolution origin
    flat0 = (vox[:, 2] * nyv + vox[:, 1]) * nxv + vox[:, 0]

    if D > 1:
        if nzv % D != 0:
            return None
        slab = nzv // D
        if vl > 0 and slab % (1 << vl) != 0:
            return None  # coarse blocks would straddle slab boundaries
        owner_expected = (vox[:, 2] // slab).astype(leaves.owner.dtype)
        if not np.array_equal(leaves.owner, owner_expected):
            return None

    leaf_idx = np.zeros(n_vox, dtype=np.int32)
    leaf_level = np.zeros(n_vox, dtype=np.int32)
    leaf_fine = np.zeros(n_vox, dtype=bool)
    fine = lvl == vl
    lin = np.arange(N, dtype=np.int32)
    leaf_idx[flat0[fine]] = lin[fine]
    leaf_level[flat0[fine]] = vl
    leaf_fine[flat0[fine]] = True
    for l in range(vl):
        sel = np.flatnonzero(lvl == l)
        if not len(sel):
            continue
        B = 1 << (vl - l)
        dz, dy, dx = np.meshgrid(
            np.arange(B), np.arange(B), np.arange(B), indexing="ij"
        )
        off = ((dz.ravel() * nyv + dy.ravel()) * nxv + dx.ravel())
        tgt = flat0[sel][:, None] + off[None, :]
        leaf_idx[tgt] = lin[sel][:, None]
        leaf_level[tgt] = l

    R = epoch.R
    row_of = epoch.row_of
    if D == 1:
        rows = row_of[leaf_idx].astype(np.int32)
        wb_rows = np.zeros(R, dtype=np.int32)
        wb_valid = np.zeros(R, dtype=bool)
        wb_rows[row_of] = flat0
        wb_valid[row_of] = True
    else:
        slab = nzv // D
        n_loc = slab * nyv * nxv
        rows = row_of[leaf_idx].astype(np.int32).reshape(D, n_loc)
        wb_rows = np.zeros((D, R), dtype=np.int32)
        wb_valid = np.zeros((D, R), dtype=bool)
        dev = leaves.owner.astype(np.int64)
        loc0 = flat0 - dev * n_loc
        wb_rows[dev, row_of] = loc0
        wb_valid[dev, row_of] = True

    return dict(
        shape=(nzv, nyv, nxv),
        vox_level=vl,
        n_devices=D,
        leaf_idx=leaf_idx,
        leaf_level=leaf_level.reshape(nzv, nyv, nxv),
        leaf_fine=leaf_fine.reshape(nzv, nyv, nxv),
        rows=rows,
        wb_rows=wb_rows,
        wb_valid=wb_valid,
    )


def build_flat_amr_tables(grid):
    """Static tables for the two-level flat layout, or None if the grid does
    not qualify (the shared layout's rules, plus: some refinement — uniform
    grids take the dense path — some coarse leaves, and the fit rule).

    Adds to :func:`flat_voxel_layout`: area_f, vol_f, vol_c, periodic."""
    lay = flat_voxel_layout(
        grid, max_voxels=_FLAT_VMEM_BUDGET // (_FLAT_ARRAYS * 4))
    if lay is None:
        return None
    if lay["leaf_fine"].all():
        return None  # every leaf refined: no coarse level

    l1 = np.asarray(grid.geometry.get_level_0_cell_length(), np.float64) / 2.0
    return dict(
        lay,
        area_f=np.array([l1[1] * l1[2], l1[0] * l1[2], l1[0] * l1[1]]),
        vol_f=float(l1.prod()),
        vol_c=float(l1.prod() * 8.0),
        periodic=tuple(bool(grid.topology.is_periodic(d)) for d in range(3)),
    )


#: deepest leaf level the multi-level flat scheme inflates to
_ML_MAX_VL = 4


def build_flat_ml_tables(grid):
    """Multi-level flat layout (3+ leaf levels), or None when the grid does
    not qualify.  Every leaf is replicated over its 2^d-cube of
    finest-level voxels; ``updf`` folds 1/vol_fine into the finest-voxel
    mask, ``pool`` masks the coarser voxels, and per doubling k the capture
    masks ``cap_origin[k]`` mark level ``vl-1-k`` leaves' block origins at
    full resolution with their 1/vol folded in (``caps[k]``: the same at
    the reduced resolution of that level, for the pyramid form)."""
    epoch = grid.epoch
    D = epoch.n_devices
    if len(epoch.leaves) == 0:
        return None
    # cheap level screen before the O(n_vox) layout build: levels {0, 1}
    # belong to the two-level form
    vl = int(
        epoch.mapping.get_refinement_level(epoch.leaves.cells).max()
    )
    if vl < 2:
        return None
    lay = flat_voxel_layout(grid, allow_multi_device=True, max_vl=_ML_MAX_VL)
    if lay is None:
        return None
    nzv, nyv, nxv = lay["shape"]
    nzl = nzv // D
    n_vox = nzv * nyv * nxv
    N = len(epoch.leaves)
    # cost guards: inflation within a modest factor of the real leaf
    # count, per-device residency within device-memory comfort
    if n_vox > max(16 * N, 1 << 22):
        return None
    if 14 * (n_vox // D) * 4 > (2 << 30):
        return None

    lev = lay["leaf_level"]                         # (nzv, nyv, nxv)
    lidx = lay["leaf_idx"].reshape(nzv, nyv, nxv)

    def ringed(a):
        """Per-slot slab with the z-neighbor slots' edge planes."""
        return np.stack([
            np.concatenate([
                a[(d * nzl - 1) % nzv][None],
                a[d * nzl:(d + 1) * nzl],
                a[((d + 1) * nzl) % nzv][None],
            ])
            for d in range(D)
        ])

    rows = lay["rows"]
    wb_rows, wb_valid = lay["wb_rows"], lay["wb_valid"]
    if D == 1:
        rows = rows[None, :]
        wb_rows = wb_rows[None, :]
        wb_valid = wb_valid[None, :]

    l0 = np.asarray(grid.geometry.get_level_0_cell_length(), np.float64)
    lf = l0 / (1 << vl)                             # finest cell lengths
    vol_f = float(lf.prod())

    lev_loc = lev.reshape(D, nzl, nyv, nxv)
    # volume tables in f64: a run casts them to its own dtype
    updf = (lev_loc == vl).astype(np.float64) / vol_f
    pool = (lev_loc < vl).astype(np.float64)
    caps = []
    cap_origin = []
    if D == 1:
        zi, yi, xi = np.meshgrid(np.arange(nzl), np.arange(nyv),
                                 np.arange(nxv), indexing="ij")
    for k in range(vl):
        l = vl - 1 - k
        f = 1 << (k + 1)
        lev_red = lev_loc[:, ::f, ::f, ::f]
        inv_vol = 1.0 / (vol_f * float(8 ** (k + 1)))
        caps.append((lev_red == l).astype(np.float64) * inv_vol)
        if D == 1:
            # capture points of the whole-run kernel, full resolution
            aligned = (zi % f == 0) & (yi % f == 0) & (xi % f == 0)
            cap_origin.append(
                ((lev_loc == l) & aligned[None]).astype(np.float64)
                * inv_vol
            )

    return dict(
        shape=(nzl, nyv, nxv),
        vl=vl,
        n_devices=D,
        rows=rows,
        wb_rows=wb_rows,
        wb_valid=wb_valid,
        lev=lev_loc,
        lev_ext=ringed(lev),
        lidx=lidx.reshape(D, nzl, nyv, nxv),
        lidx_ext=ringed(lidx),
        updf=updf,
        pool=pool,
        caps=caps,
        cap_origin=cap_origin,
        cap_active=[bool(c.any()) for c in caps],
        area_f=np.array([lf[1] * lf[2], lf[0] * lf[2], lf[0] * lf[1]]),
        periodic=tuple(bool(grid.topology.is_periodic(d)) for d in range(3)),
        n_vox=n_vox,
    )


# ------------------------------------------------------------ face weights

def _iota(shape, axis: int, device):
    """Integer position along ``axis`` broadcast to ``shape``."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).view(view).expand(shape)


def _rnd(v, like: torch.Tensor) -> float:
    """``v`` rounded to ``like``'s float dtype (the JAX forms' ``dtype(v)``
    constants)."""
    return float(torch.tensor(v, dtype=torch.float64).to(like.dtype))


def _count_h2d(site: str, *arrays) -> None:
    """Count host ``arrays`` put on the device by one weights call, as the
    advection model's ``advection.h2d_copies`` / ``advection.h2d_bytes``
    at ``site`` (on any device: what the call issues)."""
    if _metrics.enabled:
        labels = {"site": site}
        _metrics.inc_many([
            ("advection.h2d_copies", len(arrays), labels),
            ("advection.h2d_bytes", sum(int(a.nbytes) for a in arrays), labels)])


def _face_weights(vl, vh, fl, fh, pos, area_d, extra_invalid=None):
    """Signed upwind weight pair for the faces pairing (low, high) voxel
    planes, two-level form: the reference's 2:1 length-weighted face
    velocity (``solve.hpp:168-175``), intra-coarse-block pairs (low side
    at even position) carry no face, ``extra_invalid`` masks e.g.
    non-periodic wrap faces.  In the velocities' dtype, each op rounded on
    its own."""
    third = _rnd(1.0 / 3.0, vl)
    vface = torch.where(
        fl == fh,
        0.5 * (vl + vh),                      # same-kind: plain average
        torch.where(
            fl,                               # fine low, coarse high
            (2.0 * vl + vh) * third,
            (vl + 2.0 * vh) * third,
        ),
    )
    valid = ~((~fl) & (~fh) & (pos % 2 == 0))
    if extra_invalid is not None:
        valid = valid & ~extra_invalid
    zero = torch.zeros((), dtype=vface.dtype, device=vface.device)
    w = torch.where(valid, vface * _rnd(area_d, vl), zero)
    wp = torch.where(vface >= 0, w, zero)
    return wp, w - wp


def compute_flat_weights(tables, VX, VY, VZ):
    """Per-voxel-face upwind weights ``[(wpx, wnx), (wpy, wny), (wpz,
    wnz)]`` of the two-level layout, float32, from ``[nz1, ny1, nx1]``
    velocities.  For each axis the face above voxel p pairs (p, p+e_d);
    ``F = V*wp + roll(V,-1,ax)*wn`` is the signed outgoing flux without
    ``dt``.  Velocities are loop-invariant, so a run computes these once."""
    nz1, ny1, nx1 = tables["shape"]
    shape = (nz1, ny1, nx1)
    dev = VX.device
    leaf = torch.as_tensor(tables["leaf_fine"], device=dev)
    _count_h2d("flat.weights", tables["leaf_fine"])
    area = tables["area_f"]
    periodic = tables["periodic"]
    out = []
    for d, vel in enumerate((VX, VY, VZ)):
        ax = 2 - d
        n = (nx1, ny1, nz1)[d]
        v = vel.to(torch.float32)
        pos = _iota(shape, ax, dev)
        extra = None if periodic[d] else (pos == n - 1)
        out.append(_face_weights(
            v, torch.roll(v, -1, ax), leaf, torch.roll(leaf, -1, ax),
            pos, area[d], extra,
        ))
    return out


def _face_weights_ml(va, vb, la, lb, ia, ib, area_d, extra_invalid):
    """Signed upwind weight pair for the multi-level layout: the
    length-weighted face velocity (2:1 balance keeps level differences
    <= 1), intra-leaf pairs (same leaf on both sides) carry no face.  In
    the velocities' dtype."""
    third = _rnd(1.0 / 3.0, va)
    vface = torch.where(
        la == lb,
        0.5 * (va + vb),
        torch.where(
            la > lb,                          # a finer than b
            (2.0 * va + vb) * third,
            (va + 2.0 * vb) * third,
        ),
    )
    valid = ia != ib
    if extra_invalid is not None:
        valid = valid & ~extra_invalid
    zero = torch.zeros((), dtype=vface.dtype, device=vface.device)
    w = torch.where(valid, vface * _rnd(area_d, va), zero)
    wp = torch.where(vface >= 0, w, zero)
    return wp, w - wp


def compute_flat_ml_weights(tables, VX, VY, VZ, dtype=torch.float32):
    """Per-voxel-face upwind weights of the multi-level layout on one
    device (full-domain rolls = periodic wrap), in ``dtype``."""
    nzl, nyv, nxv = tables["shape"]
    if tables["n_devices"] != 1:
        raise ValueError("compute_flat_ml_weights takes a one-device layout")
    shape = (nzl, nyv, nxv)
    dev = VX.device
    lev = torch.as_tensor(tables["lev"][0], device=dev)
    lidx = torch.as_tensor(tables["lidx"][0], device=dev)
    _count_h2d("flat.ml_weights", tables["lev"][0], tables["lidx"][0])
    area = tables["area_f"]
    periodic = tables["periodic"]
    out = []
    for d, vel, n in ((0, VX, nxv), (1, VY, nyv), (2, VZ, nzl)):
        ax = 2 - d
        v = vel.to(dtype)
        pos = _iota(shape, ax, dev)
        extra = None if periodic[d] else (pos == n - 1)
        out.append(_face_weights_ml(
            v, torch.roll(v, -1, ax),
            lev, torch.roll(lev, -1, ax),
            lidx, torch.roll(lidx, -1, ax),
            area[d], extra,
        ))
    return out


# ------------------------------------------------------------ plain twins

def _premultiply(weights, dt):
    """The six face weights times ``dt`` (float32): the wrapper's one torch
    multiply, shared by kernel and twin so both see identical weights."""
    dt = _f32(dt)
    return [w * dt for w in weights]


def _delta(v, w):
    """Flux divergence of one step in the kernels' order: per axis x, y, z
    ``f = v*wp + roll(v,-1)*wn``, then ``((d + f[p-1]) - f)``."""
    wpx, wnx, wpy, wny, wpz, wnz = w
    fx = v * wpx + torch.roll(v, -1, 2) * wnx
    delta = torch.roll(fx, 1, 2) - fx
    fy = v * wpy + torch.roll(v, -1, 1) * wny
    delta = delta + torch.roll(fy, 1, 1) - fy
    fz = v * wpz + torch.roll(v, -1, 0) * wnz
    delta = delta + torch.roll(fz, 1, 0) - fz
    return delta


def flat_amr_run_plain(V, wpx, wnx, wpy, wny, wpz, wnz, upd_f, upd_c, dt,
                       steps):
    """Twin of :func:`flat_amr_run`: the JAX kernel body
    (``make_flat_amr_run``) line for line, with ``torch.roll``."""
    PLAIN_CALLS["flat_amr_run"] += 1
    w = _premultiply((wpx, wnx, wpy, wny, wpz, wnz), dt)
    shape = tuple(V.shape)
    # pool mask = coarse voxels (upd_c is 0 or 1/vol_c); origin mask =
    # even position on every axis
    pool = (upd_c != 0).to(torch.float32)
    even = [(_iota(shape, a, V.device) % 2 == 0) for a in range(3)]
    orig = (even[0] & even[1] & even[2]).to(torch.float32)
    v = V.clone()
    for _ in range(int(steps)):
        delta = _delta(v, w)
        # 2x2x2 block sum of coarse deltas at block origins (roll chain:
        # x pairs, then y, then z), origins only, broadcast over the block
        s = delta * pool
        s = s + torch.roll(s, -1, 2)
        s = s + torch.roll(s, -1, 1)
        s = s + torch.roll(s, -1, 0)
        s = s * orig
        s = s + torch.roll(s, 1, 2)
        s = s + torch.roll(s, 1, 1)
        s = s + torch.roll(s, 1, 0)
        v = v + delta * upd_f + s * upd_c
    return v


def _kmax(cap_active) -> int:
    """The coarsest doubling the pooling must reach (-1: none)."""
    return max((k for k, a in enumerate(cap_active) if a), default=-1)


def flat_ml_run_plain(V, wpx, wnx, wpy, wny, wpz, wnz, updf, pool, caps, dt,
                      steps, *, cap_active):
    """Twin of :func:`flat_ml_run`: the JAX kernel body
    (``make_flat_ml_run_pallas``) line for line, with ``torch.roll``."""
    PLAIN_CALLS["flat_ml_run"] += 1
    w = _premultiply((wpx, wnx, wpy, wny, wpz, wnz), dt)
    kmax = _kmax(cap_active)
    v = V.clone()
    for _ in range(int(steps)):
        delta = _delta(v, w)
        res_add = delta * updf
        # hierarchical pool: after doubling k, position p holds the sum of
        # s over its 2^(k+1)-cube; captures read it at level-aligned block
        # origins and broadcast it over the block with shifts < block size
        s = delta * pool
        for k in range(kmax + 1):
            h = 1 << k
            s = s + torch.roll(s, -h, 2)
            s = s + torch.roll(s, -h, 1)
            s = s + torch.roll(s, -h, 0)
            if not cap_active[k]:
                continue
            c = s * caps[k]
            for j in range(k, -1, -1):
                hj = 1 << j
                c = c + torch.roll(c, hj, 2)
                c = c + torch.roll(c, hj, 1)
                c = c + torch.roll(c, hj, 0)
            res_add = res_add + c
        v = v + res_add
    return v


# --------------------------------------------------------------- kernels

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flat_amr_run": [_PTR] * 11 + [_INT] * 12 + [_PTR],
    "flat_ml_run": [_PTR] * 12 + [_INT] * 14 + [_PTR],
}
_lib = None


def _kernels():
    """The compiled ``csrc/flat_amr.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("flat_amr")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_all(names, tensors, shape, device):
    for nm, t in zip(names, tensors):
        _check(nm, t, shape, device)


_W_NAMES = ("wpx", "wnx", "wpy", "wny", "wpz", "wnz")


def _check_steps(steps) -> int:
    steps = int(steps)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    return steps


def _plan_args(plan: FlatRunPlan):
    """The launcher's plan arguments: parts, threads, units a thread,
    weights on chip, shared memory bytes, face slot floats."""
    return (*plan.parts, plan.threads, plan.units_per_thread,
            int(plan.weights_on_chip), plan.smem_bytes, plan.face_floats)


def _faces(plan: FlatRunPlan, device):
    """The global face buffer: two parities x CTAs x six face slots."""
    return torch.empty(2 * plan.ctas * 6 * plan.face_floats,
                       dtype=torch.float32, device=device)


def flat_amr_run(V, wpx, wnx, wpy, wny, wpz, wnz, upd_f, upd_c, dt, steps):
    """Advance the flat two-level voxel grid ``V [nz1, ny1, nx1]`` (float32,
    even extents) ``steps`` timesteps in one launch.  ``w*`` are the face
    weights of :func:`compute_flat_weights` (without ``dt``), ``upd_f =
    leaf_fine/vol_f`` and ``upd_c = (~leaf_fine)/vol_c``.  Returns the new
    ``V``.  Arrays are unpadded: the JAX kernel's ``nx_pad`` lane padding
    only aligns TPU rolls and is bit-identical by its own contract."""
    tensors = (V, wpx, wnx, wpy, wny, wpz, wnz, upd_f, upd_c)
    if _on_cpu(*tensors):
        return flat_amr_run_plain(*tensors, dt, steps)
    dev = V.device
    shape = tuple(V.shape)
    if len(shape) != 3 or any(n % 2 for n in shape):
        raise ValueError(f"V must be 3-D with even extents, got {shape}")
    _check_all(("V",) + _W_NAMES + ("upd_f", "upd_c"), tensors, shape, dev)
    steps = _check_steps(steps)
    w = _premultiply(tensors[1:7], dt)
    plan = flat_amr_run_plan(*shape, *card_limits(dev.index))
    out = torch.empty_like(V)
    faces = _faces(plan, dev)
    err = _kernels().flat_amr_run(
        V.data_ptr(), *(t.data_ptr() for t in w), upd_f.data_ptr(),
        upd_c.data_ptr(), out.data_ptr(), faces.data_ptr(), *shape, steps,
        *_plan_args(plan), torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("flat_amr_run", err)
    return out


def flat_ml_run(V, wpx, wnx, wpy, wny, wpz, wnz, updf, pool, caps, dt, steps,
                *, cap_active):
    """Advance the flat multi-level voxel grid ``V [nz, ny, nx]`` (float32)
    ``steps`` timesteps in one launch.  ``updf``/``pool``/``caps`` are the
    one-device ``build_flat_ml_tables`` masks (``caps[k] =
    cap_origin[k]``) as float32, ``cap_active[k]`` whether level
    ``vl-1-k`` has leaves.  Returns the new ``V``."""
    kmax = _kmax(cap_active)
    caps = list(caps)[:kmax + 1]
    tensors = (V, wpx, wnx, wpy, wny, wpz, wnz, updf, pool, *caps)
    if _on_cpu(*tensors):
        return flat_ml_run_plain(*tensors[:9], caps, dt, steps,
                                 cap_active=cap_active)
    dev = V.device
    shape = tuple(V.shape)
    edge = 1 << (kmax + 1)
    if len(shape) != 3 or any(n % edge for n in shape):
        raise ValueError(f"V {shape} must tile into cubes of edge {edge}")
    names = ("V",) + _W_NAMES + ("updf", "pool") + tuple(
        f"caps[{k}]" for k in range(len(caps)))
    _check_all(names, tensors, shape, dev)
    steps = _check_steps(steps)
    w = _premultiply(tensors[1:7], dt)
    cap_stack = (torch.stack(caps) if caps else
                 torch.zeros((1,) + shape, dtype=torch.float32, device=dev))
    active = sum(1 << k for k in range(kmax + 1) if cap_active[k])
    plan = flat_ml_run_plan(*shape, kmax, *card_limits(dev.index))
    out = torch.empty_like(V)
    faces = _faces(plan, dev)
    err = _kernels().flat_ml_run(
        V.data_ptr(), *(t.data_ptr() for t in w), updf.data_ptr(),
        pool.data_ptr(), cap_stack.data_ptr(), out.data_ptr(),
        faces.data_ptr(), *shape, steps, kmax, active, *_plan_args(plan),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("flat_ml_run", err)
    return out


# ------------------------------------------------------- XLA forms (torch)

def _np_dtype(dtype):
    return np.dtype(str(dtype).replace("torch.", ""))


def build_flat_amr_sharded(grid):
    """Multi-slot flat layout: the level-1-resolution domain z-slab sharded
    over the slots, one slab per slot — the multi-slot form of the
    two-level scheme, with the per-step halo two voxel planes (the dense
    path's ring).

    Requires the shared layout's multi-slot rules (levels {0, 1} with
    refinement, Cartesian, slabs holding whole coarse blocks, ownership
    equal to the voxel-slab partition) and the JAX package's cost guards.
    Returns the static tables dict or None."""
    epoch = grid.epoch
    D = epoch.n_devices
    if D == 1:
        return None
    lay = flat_voxel_layout(grid, allow_uniform=False,
                            allow_multi_device=True)
    if lay is None or lay["leaf_fine"].all():
        return None
    nz1, ny1, nx1 = lay["shape"]
    nzl1 = nz1 // D
    n_loc = nzl1 * ny1 * nx1
    n_vox = nz1 * ny1 * nx1
    N = len(epoch.leaves)
    # cost guards (the JAX package's): the 8x inflation within a modest
    # factor of the real leaf count, ~12 per-slot voxel arrays in 2 GiB
    if n_vox > max(8 * N, 1 << 22):
        return None
    if 12 * n_loc * 4 > (2 << 30):
        return None

    # ringed leaf mask: the z-neighbor slots' edge planes
    lf_global = lay["leaf_fine"]
    leaf_ext = np.stack([
        np.concatenate([
            lf_global[(d * nzl1 - 1) % nz1][None],
            lf_global[d * nzl1:(d + 1) * nzl1],
            lf_global[((d + 1) * nzl1) % nz1][None],
        ])
        for d in range(D)
    ])

    l1 = np.asarray(grid.geometry.get_level_0_cell_length(), np.float64) / 2.0
    return dict(
        shape=(nzl1, ny1, nx1),
        n_devices=D,
        rows=lay["rows"],
        leaf_fine=lf_global.reshape(D, nzl1, ny1, nx1),
        leaf_ext=leaf_ext,
        wb_rows=lay["wb_rows"],
        wb_valid=lay["wb_valid"],
        area_f=np.array([l1[1] * l1[2], l1[0] * l1[2], l1[0] * l1[1]]),
        vol_f=float(l1.prod()),
        vol_c=float(l1.prod() * 8.0),
        periodic=tuple(bool(grid.topology.is_periodic(d)) for d in range(3)),
    )


class _SlabRun:
    """What the two XLA forms share: the static row tables on the device,
    the per-slot voxel gather of a field, the z ring, and the write-back
    ``where(wb_valid, out[wb_rows], density)``.

    Under several controllers (``parallel/mesh.py``) every ``[D, ...]``
    table is this controller's block of slots (:meth:`put_slots`), the ring
    is the controllers' slab ring (``HaloExtend``'s controller form: two
    planes over the transport a call), and the global z faces and open-z
    masks keep the global slot index (:meth:`gface`)."""

    def __init__(self, grid, tables, dtype):
        from ..parallel.dense import HaloExtend

        self.grid = grid
        self.device = grid.device
        self.dtype = dtype
        #: every slot (``D``) and this controller's (``Dl``, from ``lo``)
        self.D = tables["n_devices"]
        self.Dl, self.lo = len(grid.slots), grid.slots.start
        self.shape = tuple(tables["shape"])
        self.ring = HaloExtend(self.D, grid.controllers)
        self.rows = self.put_slots(tables["rows"], torch.int64)
        self.wb_rows = self.put_slots(tables["wb_rows"], torch.int64)
        self.wb_valid = self.put_slots(tables["wb_valid"], torch.bool)

    def put(self, a, dt=None):
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        return t if dt is None else t.to(dt)

    def put_slots(self, a, dt=None):
        """:meth:`put` of this controller's slots of a ``[D, ...]`` table."""
        return self.put(self.grid.slot_view(np.asarray(a)), dt)

    def field(self, rows_state):
        return (torch.gather(rows_state, 1, self.rows)
                .reshape((self.Dl,) + self.shape).to(self.dtype))

    def zext(self, v):
        below, above = self.ring.planes(v)
        return torch.cat([below, v, above], dim=1)

    def gface(self):
        """Global z face index ``slot*nzl - 1 + j`` of the nzl+1 faces of
        each slot's ringed slab, ``[Dl, nzl+1, 1, 1]`` (global slots)."""
        nzl = self.shape[0]
        d = torch.arange(self.lo, self.lo + self.Dl,
                         device=self.device).view(-1, 1, 1, 1)
        j = torch.arange(nzl + 1, device=self.device).view(1, -1, 1, 1)
        return d * nzl - 1 + j

    def dt(self, dt) -> float:
        return float(_np_dtype(self.dtype).type(dt))

    def write_back(self, state, out):
        rho_rows = state["density"]
        vals = torch.gather(out.reshape(self.Dl, -1), 1, self.wb_rows)
        rho = torch.where(self.wb_valid, vals.to(rho_rows.dtype), rho_rows)
        return {**state, "density": rho,
                "flux": torch.zeros_like(state["flux"])}

    @staticmethod
    def delta(Vc, wpx, wnx, wpy, wny, fz_faces):
        """Flux divergence in the JAX forms' order: x, y, then the ringed
        z faces."""
        fx = Vc * wpx + torch.roll(Vc, -1, 3) * wnx
        fy = Vc * wpy + torch.roll(Vc, -1, 2) * wny
        delta = torch.roll(fx, 1, 3) - fx
        delta = delta + torch.roll(fy, 1, 2) - fy
        return delta + fz_faces[:, :-1] - fz_faces[:, 1:]


def make_flat_amr_run_sharded(grid, tables, dtype=torch.float32):
    """``run(state, steps, dt) -> state`` (its z ring as ``run.ring``) of the
    multi-slot two-level flat form (the JAX package's
    ``make_flat_amr_run_sharded``, plain torch):
    per step two ringed voxel planes and one weighted flux pass plus the
    intra-slab 2x2x2 pool/broadcast (coarse blocks never straddle slabs).
    The weights are computed once a run from the ringed velocity fields,
    with ``dt`` premultiplied as in the one-slot kernel's wrapper."""
    sr = _SlabRun(grid, tables, dtype)
    D, (nzl1, ny1, nx1) = sr.D, sr.shape
    px, py, pz = tables["periodic"]
    area = tables["area_f"]
    nd = _np_dtype(dtype)
    inv_vf = float(nd.type(1.0 / tables["vol_f"]))
    inv_vc = float(nd.type(1.0 / tables["vol_c"]))
    leaf = sr.put_slots(tables["leaf_fine"])
    leaf_ext = sr.put_slots(tables["leaf_ext"])
    full = (sr.Dl, nzl1, ny1, nx1)
    updf = leaf.to(dtype) * inv_vf
    pool = (~leaf).to(dtype)
    updc = pool * inv_vc
    even = [_iota(full, a, sr.device) % 2 == 0 for a in (1, 2, 3)]
    orig = (even[2] & even[1] & even[0]).to(dtype)

    def run(state, steps, dt):
        V = sr.field(state["density"])
        VX, VY, VZ = (sr.field(state[k]) for k in ("vx", "vy", "vz"))
        w_xy = []
        for d2, vel, n in ((0, VX, nx1), (1, VY, ny1)):
            ax = 3 - d2
            pos = _iota(full, ax, sr.device)
            extra = None if (px, py)[d2] else (pos == n - 1)
            w_xy.append(_face_weights(
                vel, torch.roll(vel, -1, ax), leaf, torch.roll(leaf, -1, ax),
                pos, area[d2], extra,
            ))
        (wpx, wnx), (wpy, wny) = w_xy
        VZe = sr.zext(VZ)
        gface = sr.gface()
        extra_z = None if pz else (gface == -1) | (gface == D * nzl1 - 1)
        wzp, wzn = _face_weights(
            VZe[:, :-1], VZe[:, 1:], leaf_ext[:, :-1], leaf_ext[:, 1:],
            gface, area[2], extra_z,
        )
        dtc = sr.dt(dt)
        wpx, wnx, wpy, wny = wpx * dtc, wnx * dtc, wpy * dtc, wny * dtc
        wzp, wzn = wzp * dtc, wzn * dtc

        Vc = V
        for _ in range(int(steps)):
            Ve = sr.zext(Vc)
            fz_faces = Ve[:, :-1] * wzp + Ve[:, 1:] * wzn
            delta = sr.delta(Vc, wpx, wnx, wpy, wny, fz_faces)
            s = delta * pool
            s = s + torch.roll(s, -1, 3)
            s = s + torch.roll(s, -1, 2)
            s = s + torch.roll(s, -1, 1)
            s = s * orig
            s = s + torch.roll(s, 1, 3)
            s = s + torch.roll(s, 1, 2)
            s = s + torch.roll(s, 1, 1)
            Vc = Vc + (delta * updf + s * updc)
        return sr.write_back(state, Vc)

    run.ring = sr.ring
    return run


def make_flat_ml_run(grid, tables, dtype=torch.float32):
    """``run(state, steps, dt) -> state`` (its z ring as ``run.ring``) of the
    multi-level flat form (the
    JAX package's ``make_flat_ml_run``, plain torch, any slot count): per
    step two ringed voxel planes, one weighted flux pass, and the reshape
    pyramid — the coarse leaves' block sums pooled down one 2x2x2
    reduction a doubling, captured at their own resolution, and broadcast
    back up."""
    sr = _SlabRun(grid, tables, dtype)
    D, (nzl, nyv, nxv) = sr.D, sr.shape
    vl = tables["vl"]
    px, py, pz = tables["periodic"]
    area = tables["area_f"]
    cap_active = tables["cap_active"]
    kmax = _kmax(cap_active)
    lev, lev_ext = sr.put_slots(tables["lev"]), sr.put_slots(tables["lev_ext"])
    lidx, lidx_ext = sr.put_slots(tables["lidx"]), sr.put_slots(tables["lidx_ext"])
    # volume tables stored in f64, shipped in the run's dtype
    updf = sr.put_slots(tables["updf"], dtype)
    pool = sr.put_slots(tables["pool"], dtype)
    caps = [sr.put_slots(c, dtype) for c in tables["caps"]]
    full = (sr.Dl, nzl, nyv, nxv)

    def down2(a):
        D_, nz_, ny_, nx_ = a.shape
        return a.reshape(D_, nz_ // 2, 2, ny_ // 2, 2, nx_ // 2, 2).sum(
            dim=(2, 4, 6))

    def up2(a):
        D_, nz_, ny_, nx_ = a.shape
        return a[:, :, None, :, None, :, None].expand(
            D_, nz_, 2, ny_, 2, nx_, 2).reshape(D_, nz_ * 2, ny_ * 2, nx_ * 2)

    def run(state, steps, dt):
        V = sr.field(state["density"])
        VX, VY, VZ = (sr.field(state[k]) for k in ("vx", "vy", "vz"))
        w_xy = []
        for d2, vel, n in ((0, VX, nxv), (1, VY, nyv)):
            ax = 3 - d2
            pos = _iota(full, ax, sr.device)
            extra = None if (px, py)[d2] else (pos == n - 1)
            w_xy.append(_face_weights_ml(
                vel, torch.roll(vel, -1, ax),
                lev, torch.roll(lev, -1, ax),
                lidx, torch.roll(lidx, -1, ax),
                area[d2], extra,
            ))
        (wpx, wnx), (wpy, wny) = w_xy
        VZe = sr.zext(VZ)
        gface = sr.gface()
        extra_z = None if pz else (gface == -1) | (gface == D * nzl - 1)
        wzp, wzn = _face_weights_ml(
            VZe[:, :-1], VZe[:, 1:], lev_ext[:, :-1], lev_ext[:, 1:],
            lidx_ext[:, :-1], lidx_ext[:, 1:], area[2], extra_z,
        )
        dtc = sr.dt(dt)
        wpx, wnx, wpy, wny = wpx * dtc, wnx * dtc, wpy * dtc, wny * dtc
        wzp, wzn = wzp * dtc, wzn * dtc

        Vc = V
        for _ in range(int(steps)):
            Ve = sr.zext(Vc)
            fz_faces = Ve[:, :-1] * wzp + Ve[:, 1:] * wzn
            delta = sr.delta(Vc, wpx, wnx, wpy, wny, fz_faces)
            out_add = delta * updf
            if kmax >= 0:
                subs = []
                cur = delta * pool
                for _k in range(kmax + 1):
                    cur = down2(cur)
                    subs.append(cur)
                acc = None
                for k in range(kmax, -1, -1):
                    if acc is not None:
                        acc = up2(acc)
                    if cap_active[k]:
                        contrib = subs[k] * caps[k]
                        acc = contrib if acc is None else acc + contrib
                if acc is not None:
                    out_add = out_add + up2(acc)
            Vc = Vc + out_add
        return sr.write_back(state, Vc)

    run.ring = sr.ring
    return run
