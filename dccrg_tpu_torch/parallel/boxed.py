"""Boxed (per-level dense) layout — the block-structured AMR fast path.

A copy of the JAX package's ``parallel/boxed.py`` (numpy only), with one
change: a neighbor listed more than once across the same face
(neighborhood length >= 1) is classified at its first entry only, as the
advection face tables do (``core/neighbors.py::first_faces``).

A scalar neighbor gather pays a per-row transaction for every scalar, while
dense shifted-slice stencils stream at memory bandwidth.  This module
therefore re-derives the reference's per-cell neighbor iteration
(``dccrg.hpp:4339-4861``) as a Berger-Oliger-style decomposition:

* every refinement level's leaves are scattered into a dense box (``[z, y,
  x]`` array order; the tight leaf bounding box on one device, or the full
  domain in z and the bounding box in x/y multi-device) — same-level face
  coupling, asymptotically all of the work, becomes masked shifted slices;
* cross-level faces (an O(surface) set, |level difference| == 1 by the 2:1
  invariant) are ALSO dense: per adjacent level pair, boolean fine-side
  face masks (``CrossPair``) drive a kernel that upsamples the coarse box
  2x over the fine box's footprint, computes per-fine-face mass fluxes as
  masked dense arrays, and routes their exact negations to the coarse
  receivers by a parity-aligned 2x sum-pool — no gathers or scatters.

Multi-slot: each level's box is z-slab partitioned over the slots
(``bz == nz0 * 2^level`` divisible by D, one equal slab per slot — the
same decomposition as ``parallel/dense.py`` for uniform grids, which this
layout generalizes).  The z ring is a circular plane exchange over the
slot axis per level per step; periodic z wrap IS the circular slot ring.
The grid qualifies when ownership is the z-slab partition by level-0 row
(the initial BLOCK striping of an unrefined grid, preserved by refinement
since children inherit the parent's owner; restorable after other
balancing with the ``ZSLAB`` method).

Correctness notes:

* ``face_valid`` masks are scattered directly from the same-level face
  entries of the neighbor lists, so the dense kernel covers *exactly* the
  pairs the general gather path would; z-wrap faces register at their true
  (modulo) interior coordinate, x/y wraps can only occur when the box
  spans the full axis (both endpoints hold leaves of that level), making
  the wrap ring pad exact.
* the builder returns ``None`` whenever the layout does not apply
  (non-slab partition, D not dividing nz, non-uniform per-level geometry,
  missing face offsets in the neighborhood, or pathological bounding-box
  blowup) — callers fall back to the flat gather path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LevelBox", "CrossPair", "BoxedLayout", "build_boxed"]

_FACE_OFFSETS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.int64,
)


@dataclass
class LevelBox:
    """One refinement level's dense box ([z, y, x] array order).

    Multi-device (``n_devices > 1``): ``lo[2] == 0`` and ``shape[0] ==
    nz0 << level`` — the z extent is the full domain so the z-slab
    partition is uniform across devices.  Single device: the tight leaf
    bounding box on every axis."""

    level: int
    lo: np.ndarray          # (3,) int64 box min corner, level-l cell units [x, y, z]
    shape: tuple            # (bz, by, bx)
    rows: np.ndarray        # (bz*by*bx,) int32 owner-local epoch row per position
    leaf_mask: np.ndarray   # (bz, by, bx) bool
    face_valid: np.ndarray  # (3, bz, by, bx) bool: +x/+y/+z face handled densely
    length: np.ndarray      # (3,) float64 physical cell length [x, y, z]


@dataclass
class CrossPair:
    """Cross-level faces between adjacent levels, expressed entirely as
    dense masks on the FINE level's box.

    The octree guarantees two structural facts this encoding relies on:
    |level difference| == 1 across any face (2:1 balance), and a fine cell
    whose +d neighbor is coarser sits at an odd global fine coordinate
    along d (its even-side sibling position is occupied by same-or-finer
    leaves), so ``(p + e_d) >> 1 == (p >> 1) + e_d`` exactly — the coarse
    receiver of every fine face flux is reachable by a 2x sum-pool plus a
    one-cell shift, with no gather/scatter.  Both are asserted at build
    time.
    """

    fine_level: int
    coarse_level: int
    mask_plus: np.ndarray   # (3, bz, by, bx) bool: fine cell has a coarser
                            # neighbor across its +x/+y/+z face
    mask_minus: np.ndarray  # (3, bz, by, bx) bool: same for -x/-y/-z faces


@dataclass
class BoxedLayout:
    boxes: dict             # level -> LevelBox
    pairs: list             # [CrossPair]
    n_cells: int            # total leaves covered
    n_devices: int          # z-slab count (1 = single device)


def build_boxed(grid, hood_id=None, max_expand: float = 8.0):
    """Build the boxed layout for the current epoch, or return ``None`` if
    the grid does not qualify (see module docstring)."""

    epoch = grid.epoch
    D = epoch.n_devices
    if not getattr(grid.geometry, "uniform_level0", False):
        return None
    hood = epoch.hoods.get(hood_id)
    if hood is None:
        return None
    # all six face offsets must be part of the neighborhood
    offs = np.asarray(hood.offsets, dtype=np.int64)
    have = {tuple(o) for o in offs}
    if not all(tuple(f) in have for f in _FACE_OFFSETS):
        return None

    mapping = epoch.mapping
    leaves = epoch.leaves
    N = len(leaves)
    if N == 0:
        return None
    nz0 = int(mapping.length[2])
    if nz0 % D != 0:
        return None
    L = mapping.max_refinement_level
    lvl_all = mapping.get_refinement_level(leaves.cells).astype(np.int64)
    idx_all = mapping.get_indices(leaves.cells).astype(np.int64)  # (N, 3) x,y,z
    if D > 1:
        # ownership must be the z-slab partition by level-0 row
        z0 = idx_all[:, 2] >> L
        expected_owner = (z0 // (nz0 // D)).astype(leaves.owner.dtype)
        if not np.array_equal(leaves.owner, expected_owner):
            return None
    level0_len = np.asarray(grid.geometry.get_level_0_cell_length(), dtype=np.float64)

    scratch = epoch.R - 1
    levels = np.unique(lvl_all)
    boxes: dict[int, LevelBox] = {}
    total_box = 0
    for lvl in levels:
        sel = np.flatnonzero(lvl_all == lvl)
        shift = L - int(lvl)
        p = idx_all[sel] >> shift                       # (n, 3) x,y,z level units
        lo = p.min(axis=0)
        hi = p.max(axis=0) + 1
        if D > 1:
            # full-domain z extent so the z-slab partition is uniform
            # across devices; one device keeps the tight bounding box
            lo[2] = 0
            hi[2] = nz0 << int(lvl)
        dims = hi - lo
        total_box += int(dims.prod())
        # multi-device layouts get 2x headroom: the full-domain z extent
        # inflates boxes beyond the tight bound the cap was tuned for
        allow = max_expand * N if D == 1 else 2 * max_expand * N
        if total_box > max(int(allow), 1 << 22):
            return None
        bx, by, bz = int(dims[0]), int(dims[1]), int(dims[2])
        q = p - lo
        flat = (q[:, 2] * by + q[:, 1]) * bx + q[:, 0]  # [z, y, x] order
        rows = np.full(bz * by * bx, scratch, dtype=np.int32)
        rows[flat] = epoch.row_of[sel]
        leaf_mask = np.zeros(bz * by * bx, dtype=bool)
        leaf_mask[flat] = True
        boxes[int(lvl)] = LevelBox(
            level=int(lvl),
            lo=lo,
            shape=(bz, by, bx),
            rows=rows,
            leaf_mask=leaf_mask.reshape(bz, by, bx),
            face_valid=np.zeros((3, bz, by, bx), dtype=bool),
            length=level0_len / (1 << int(lvl)),
        )

    # ---- face classification over the flat neighbor lists (the E-flat
    # analogue of the advection model's [D,R,K] face tables)
    from ..core.neighbors import face_directions, first_faces

    lists = hood.lists
    counts = np.diff(lists.start)
    src = np.repeat(np.arange(N), counts)
    len_all = mapping.get_cell_length_in_indices(leaves.cells).astype(np.int64)
    off = np.asarray(lists.offset, dtype=np.int64)
    direction = face_directions(off, len_all[src], len_all[lists.nbr_pos])
    # one entry per (cell, neighbor, direction): the first in list order
    face = direction != 0
    fi = np.flatnonzero(face)
    face[fi[~first_faces(src[fi], lists.nbr_pos[fi].astype(np.int64) * 8
                         + direction[fi] + 3)]] = False

    la = lvl_all[src]
    lb = lvl_all[lists.nbr_pos]

    # ---- same-level faces: scatter +d entries into face_valid
    same = face & (la == lb) & (direction > 0)
    for lvl in levels:
        box = boxes[int(lvl)]
        sel = np.flatnonzero(same & (la == lvl))
        if not len(sel):
            continue
        shift = L - int(lvl)
        pa = (idx_all[src[sel]] >> shift) - box.lo
        d = direction[sel].astype(np.int64) - 1         # 0/1/2 = x/y/z
        fv = box.face_valid
        fv[d, pa[:, 2], pa[:, 1], pa[:, 0]] = True

    # ---- cross-level faces -> dense fine-side masks per adjacent pair
    pairs: list[CrossPair] = []
    cross = np.flatnonzero(face & (la != lb))
    if len(cross):
        if (np.abs(la[cross] - lb[cross]) != 1).any():
            return None  # 2:1 balance violated; not representable here
        # keep only the fine-side entries; the coarse side is the exact
        # mirror and is served by pooling the fine-side fluxes
        fine_e = cross[la[cross] > lb[cross]]
        coarse_e = cross[la[cross] < lb[cross]]
        if len(fine_e) != len(coarse_e):
            return None
        for F in sorted({int(v) for v in la[fine_e]}):
            sel = fine_e[la[fine_e] == F]
            fbox = boxes[F]
            shift = L - F
            p_glob = idx_all[src[sel]] >> shift         # global fine coords
            q = p_glob - fbox.lo
            d = (np.abs(direction[sel]) - 1).astype(np.int64)
            plus = direction[sel] > 0
            # octree parity invariant (see CrossPair docstring)
            par = p_glob[np.arange(len(sel)), d] & 1
            if not ((par[plus] == 1).all() and (par[~plus] == 0).all()):
                return None
            bz, by, bx = fbox.shape
            mask_plus = np.zeros((3, bz, by, bx), dtype=bool)
            mask_minus = np.zeros((3, bz, by, bx), dtype=bool)
            mask_plus[d[plus], q[plus, 2], q[plus, 1], q[plus, 0]] = True
            mask_minus[d[~plus], q[~plus, 2], q[~plus, 1], q[~plus, 0]] = True
            pairs.append(
                CrossPair(
                    fine_level=F,
                    coarse_level=F - 1,
                    mask_plus=mask_plus,
                    mask_minus=mask_minus,
                )
            )

    return BoxedLayout(boxes=boxes, pairs=pairs, n_cells=N, n_devices=D)
