"""Vectorized neighbor-list construction over the global leaf-cell set.

TPU-first re-derivation of the reference's serial pointer-walk
``find_neighbors_of`` (``dccrg.hpp:4339-4680``) and its inverse
``find_neighbors_to`` (``dccrg.hpp:4708-4861``): instead of walking a 6-face
backbone per cell, every (cell, offset-slot) pair is resolved at once with
index arithmetic plus a sorted-array existence lookup.  The output semantics
match the reference exactly:

* for each neighborhood offset ``h`` (in units of the cell's own edge
  length), the offset "slot" is the region ``[h*s, (h+1)*s)`` relative to the
  cell's min corner (s = cell length in index units);
* if the slot is covered by an existing leaf of the same or coarser level,
  that leaf is emitted once *per slot* (so a coarser neighbor appears several
  times, as in the reference);
* if the slot is covered by finer leaves, all 8 siblings of that family are
  emitted (x-fastest order);
* recorded offsets are the neighbor's min corner relative to the cell's min
  corner in index units, un-wrapped (periodic neighbors keep the logical
  direction sign, like the reference's accumulated walk offsets);
* a slot outside a non-periodic boundary emits nothing;
* neighbor refinement levels differ from the cell's by at most 1
  (``max_ref_lvl_diff == 1``, ``dccrg.hpp:7085``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mapping import Mapping
from .topology import Topology

__all__ = [
    "InconsistentGridError",
    "first_faces",
    "LeafSet",
    "NeighborLists",
    "find_all_neighbors",
    "invert_neighbors",
    "face_directions",
    "affected_closure",
    "splice_neighbor_lists",
]


class InconsistentGridError(RuntimeError):
    """A leaf set that violates the tiling/2:1 invariants the neighbor
    engine assumes (a slot inside the grid covered by no leaf of level
    l-1/l/l+1).  Callers validating untrusted leaf sets (checkpoint
    reload) catch this type rather than matching message text."""


def face_directions(off, clen, nlen):
    """Signed face axis (+-1/2/3 for x/y/z, 0 = not a face neighbor) of
    neighbor entries from their min-corner offsets — the reference's offset
    classification (tests/advection/solve.hpp:71-123): overlap in exactly
    two dimensions plus contact (offset == +cell length or == -neighbor
    length) in the third.

    ``off`` is ``(..., 3)`` in index units; ``clen``/``nlen`` (cell and
    neighbor edge lengths in index units) must broadcast to ``off``'s
    leading shape.  Shared by the flat gather tables
    (``models/advection.py``) and the boxed layout (``parallel/boxed.py``)
    so both paths classify the identical face set.
    """
    off = np.asarray(off)
    clen = np.asarray(clen)[..., None]
    nlen = np.asarray(nlen)[..., None]
    overlap = (off < clen) & (off > -nlen)
    n_overlap = overlap.sum(axis=-1)
    direction = np.zeros(off.shape[:-1], dtype=np.int8)
    for d in range(3):
        direction = np.where(
            (n_overlap == 2) & (off[..., d] == clen[..., 0]), d + 1, direction
        )
        direction = np.where(
            (n_overlap == 2) & (off[..., d] == -nlen[..., 0]), -(d + 1), direction
        )
    return direction.astype(np.int8)


def first_faces(group, key):
    """Mask of the face entries to price: True for the first entry, in
    array order, of each (``group``, ``key``) pair — ``group`` names the
    cell an entry belongs to, ``key`` its neighbor and signed direction.
    At neighborhood length n >= 1 a larger face neighbor is listed once for
    every neighborhood offset it covers; the reference meets each face
    once (``Grid.get_face_neighbors_of``), so only the first entry of each
    pair carries the face.  At length 0 every pair is unique already.
    Shared by the advection face tables (``models/advection.py``) and the
    boxed layout (``parallel/boxed.py``)."""
    group = np.asarray(group, dtype=np.int64)
    key = np.asarray(key, dtype=np.int64)
    keep = np.zeros(len(key), dtype=bool)
    if len(key):
        _, first = np.unique(group * (int(key.max()) + 1) + key, return_index=True)
        keep[first] = True
    return keep


@dataclass(frozen=True)
class LeafSet:
    """The global set of existing (leaf) cells, sorted ascending by id, with
    the owner device of each — the analogue of the reference's replicated
    ``cell_process`` directory (``dccrg.hpp:7196-7197``)."""

    cells: np.ndarray  # (N,) uint64, sorted ascending
    owner: np.ndarray  # (N,) int32 device index

    def __post_init__(self):
        assert self.cells.dtype == np.uint64
        assert (np.diff(self.cells) > 0).all(), "cells must be sorted unique"
        assert len(self.owner) == len(self.cells)

    def __len__(self) -> int:
        return len(self.cells)

    def position(self, ids) -> np.ndarray:
        """Index into ``cells`` for each id; -1 if the id is not a leaf."""
        ids = np.asarray(ids, dtype=np.uint64)
        pos = np.searchsorted(self.cells, ids)
        pos_c = np.minimum(pos, len(self.cells) - 1)
        found = self.cells[pos_c] == ids
        return np.where(found, pos_c, -1).astype(np.int64)

    def exists(self, ids) -> np.ndarray:
        return self.position(ids) >= 0


@dataclass
class NeighborLists:
    """CSR neighbors-of lists for a set of source cells.

    ``entries_*[start[i]:start[i+1]]`` are cell i's neighbors in reference
    order (slot-major, finer families expanded x-fastest).
    """

    start: np.ndarray        # (N+1,) int64 CSR row starts
    nbr_pos: np.ndarray      # (E,) int64 position of neighbor in LeafSet (>=0)
    nbr_cell: np.ndarray     # (E,) uint64 neighbor ids
    offset: np.ndarray       # (E, 3) int64 neighbor min corner - cell min corner
    slot: np.ndarray         # (E,) int32 neighborhood-offset index of each entry

    def row(self, i: int):
        sl = slice(self.start[i], self.start[i + 1])
        return self.nbr_cell[sl], self.offset[sl]


def find_all_neighbors(
    mapping: Mapping,
    topology: Topology,
    leaves: LeafSet,
    hood: np.ndarray,
    source_cells: np.ndarray | None = None,
    strict: bool = True,
) -> NeighborLists:
    """Compute neighbors-of for the given source cells (default: all
    leaves) against the full leaf set.  Vectorized over (cell, slot) pairs.
    Sources need not be leaves themselves (used for would-be parents during
    unrefinement checks); only their level/index arithmetic is used.

    With ``strict`` (the default) an inconsistent grid — a slot inside the
    grid covered by no leaf of level l-1/l/l+1 — raises, mirroring the
    reference's DEBUG invariants.
    """
    if source_cells is None:
        source_cells = leaves.cells
    src_cells = np.asarray(source_cells, dtype=np.uint64)

    # compiled fast path (identical semantics; numpy below is the source of
    # truth and fallback — see native/neighbor_kernels.cpp)
    from ..native import native_find_neighbors

    native = native_find_neighbors(
        mapping, topology, leaves.cells, np.asarray(hood, dtype=np.int64),
        src_cells, strict,
    )
    if native is not None:
        start, nbr_cell, nbr_pos, offset, slot = native
        return NeighborLists(
            start=start, nbr_pos=nbr_pos, nbr_cell=nbr_cell, offset=offset, slot=slot
        )
    N, K = len(src_cells), len(hood)
    mrl = mapping.max_refinement_level

    lvl = mapping.get_refinement_level(src_cells)          # (N,)
    idx = mapping.get_indices(src_cells).astype(np.int64)  # (N,3)
    s = mapping.get_cell_length_in_indices(src_cells).astype(np.int64)  # (N,)

    L = np.asarray(mapping.length_in_indices, dtype=np.int64)  # (3,)
    periodic = np.asarray(topology.periodic, dtype=bool)

    # slot min corner, un-wrapped: (N, K, 3)
    t = idx[:, None, :] + hood[None, :, :] * s[:, None, None]
    # periodic wrap / out-of-bounds detection
    inside = (t >= 0) & (t < L)
    t_mod = np.mod(t, L)
    valid = (inside | periodic).all(axis=2)                # (N, K)

    t_q = np.where(valid[..., None], t_mod, 0).astype(np.uint64)
    lvl_b = np.broadcast_to(lvl[:, None], (N, K))

    # candidate leaf at the cell's own level
    cand_same = mapping.get_cell_from_indices(t_q, lvl_b)
    pos_same = leaves.position(cand_same)
    has_same = valid & (pos_same >= 0)

    # coarser candidate (level l-1)
    lvl_up = np.maximum(lvl_b - 1, 0)
    cand_coarse = mapping.get_cell_from_indices(t_q, lvl_up)
    pos_coarse = leaves.position(cand_coarse)
    has_coarse = valid & ~has_same & (lvl_b > 0) & (pos_coarse >= 0)

    # finer: slot holds the 8 children of cand_same
    has_finer = valid & ~has_same & ~has_coarse & (lvl_b < mrl)
    if strict:
        unresolved = valid & ~has_same & ~has_coarse & ~has_finer
        if unresolved.any():
            i, k = np.argwhere(unresolved)[0]
            raise InconsistentGridError(
                f"inconsistent grid: no neighbor leaf for cell {src_cells[i]} "
                f"slot {tuple(hood[k])}"
            )

    counts = np.where(has_finer, 8, (has_same | has_coarse).astype(np.int64))  # (N,K)

    # ---- emit entries ordered (cell, slot, sibling) ----
    ends = np.cumsum(counts.reshape(-1))
    E = int(ends[-1]) if len(ends) else 0
    starts_flat = ends - counts.reshape(-1)

    nbr_cell = np.zeros(E, dtype=np.uint64)
    offset = np.zeros((E, 3), dtype=np.int64)
    slot_out = np.zeros(E, dtype=np.int32)

    base_off = hood[None, :, :] * s[:, None, None]         # (N, K, 3)

    # single-entry slots (same level)
    m = has_same
    if m.any():
        e = starts_flat[m.reshape(-1)]
        nbr_cell[e] = cand_same[m]
        offset[e] = base_off[m]
        slot_out[e] = np.broadcast_to(np.arange(K, dtype=np.int32), (N, K))[m]

    # single-entry slots (coarser): offset = h*s - (t_mod - coarse corner)
    m = has_coarse
    if m.any():
        e = starts_flat[m.reshape(-1)]
        nbr_cell[e] = cand_coarse[m]
        c_corner = mapping.get_indices(cand_coarse[m]).astype(np.int64)
        within = np.where(valid[..., None], t_mod, 0)[m] - c_corner
        offset[e] = base_off[m] - within
        slot_out[e] = np.broadcast_to(np.arange(K, dtype=np.int32), (N, K))[m]

    # finer slots: 8 siblings, x-fastest, offsets h*s + {0,half}^3
    m = has_finer
    if m.any():
        e0 = starts_flat[m.reshape(-1)]                    # (M,)
        children = mapping.get_all_children(cand_same[m])  # (M, 8)
        half = (np.broadcast_to(s[:, None], (N, K))[m] // 2)  # (M,)
        sib = np.stack(
            [
                np.array([0, 1, 0, 1, 0, 1, 0, 1], dtype=np.int64),
                np.array([0, 0, 1, 1, 0, 0, 1, 1], dtype=np.int64),
                np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=np.int64),
            ],
            axis=-1,
        )                                                  # (8, 3)
        e = e0[:, None] + np.arange(8)
        nbr_cell[e.reshape(-1)] = children.reshape(-1)
        offset[e.reshape(-1)] = (
            base_off[m][:, None, :] + sib[None, :, :] * half[:, None, None]
        ).reshape(-1, 3)
        slot_out[e.reshape(-1)] = np.repeat(
            np.broadcast_to(np.arange(K, dtype=np.int32), (N, K))[m], 8
        )

    nbr_pos = leaves.position(nbr_cell)
    if strict and (nbr_pos < 0).any():
        bad = nbr_cell[nbr_pos < 0][0]
        raise InconsistentGridError(
            f"neighbor {bad} is not an existing leaf (2:1 violation?)"
        )

    row_counts = counts.sum(axis=1)
    start = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(row_counts, out=start[1:])
    return NeighborLists(
        start=start, nbr_pos=nbr_pos, nbr_cell=nbr_cell, offset=offset, slot=slot_out
    )


def affected_closure(
    lists: NeighborLists,
    to_start: np.ndarray,
    to_src: np.ndarray,
    changed_pos: np.ndarray,
    n_cells: int,
) -> tuple[np.ndarray, np.ndarray]:
    """One-neighborhood-radius closure of a touched cell set, from the
    hood's existing CSR relations (no geometric search).

    ``changed_pos`` are leaf positions whose cells are removed or replaced
    by an AMR commit.  Returns two boolean masks over the ``n_cells`` old
    leaf positions:

    * ``list_closure`` — rows whose neighbors-of list can change: the
      changed rows themselves plus every row LISTING a changed cell
      (= the changed cells' neighbors-to).  A surviving row outside this
      set keeps a bit-identical list, because every old leaf covering any
      of its neighborhood slots appears in that list — so a coverage
      change implies a changed cell was listed.
    * ``target_closure`` — rows whose neighbors-to (inverse) list can
      change: every row LISTED BY a ``list_closure`` row (the inverse
      loses those rows' old contributions and regains them from the
      re-search).  New-target gains from re-searched rows are added by
      the caller once the new lists exist.
    """
    from ..utils.setops import csr_take

    list_closure = np.zeros(n_cells, dtype=bool)
    target_closure = np.zeros(n_cells, dtype=bool)
    changed_pos = np.asarray(changed_pos, dtype=np.int64)
    if len(changed_pos):
        list_closure[changed_pos] = True
        list_closure[csr_take(to_start, to_src, changed_pos)] = True
        target_closure[
            csr_take(lists.start, lists.nbr_pos, np.flatnonzero(list_closure))
        ] = True
    return list_closure, target_closure


def splice_neighbor_lists(
    old: NeighborLists,
    old_row_of_new: np.ndarray,
    pos_old_to_new: np.ndarray,
    fresh: NeighborLists,
    fresh_rows: np.ndarray,
    n_new: int,
) -> NeighborLists:
    """Forward-CSR splice: the new leaf order's ``NeighborLists`` from
    reusable old rows plus freshly searched closure rows.

    ``old_row_of_new``: (n_new,) old position whose CSR row is copied
    verbatim for each new position, -1 where the row comes from ``fresh``.
    ``pos_old_to_new``: (n_old,) new position of each old leaf (applied to
    copied ``nbr_pos`` entries; copied rows reference surviving leaves
    only, so no -1 can be gathered).
    ``fresh``: lists searched over ``fresh_rows`` (ascending new
    positions) against the new leaf set.
    """
    from ..utils.setops import ragged_arange

    old_row_of_new = np.asarray(old_row_of_new, dtype=np.int64)
    fresh_rows = np.asarray(fresh_rows, dtype=np.int64)
    kept_rows = np.flatnonzero(old_row_of_new >= 0)
    src_rows = old_row_of_new[kept_rows]

    counts = np.zeros(n_new, dtype=np.int64)
    counts[kept_rows] = old.start[src_rows + 1] - old.start[src_rows]
    counts[fresh_rows] = np.diff(fresh.start)
    start = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    E = int(start[-1])

    nbr_pos = np.empty(E, dtype=np.int64)
    nbr_cell = np.empty(E, dtype=np.uint64)
    offset = np.empty((E, 3), dtype=np.int64)
    slot = np.empty(E, dtype=np.int32)

    def _ranges(rows, row_starts):
        c = counts[rows]
        rank = ragged_arange(c)
        return np.repeat(row_starts, c) + rank, np.repeat(start[rows], c) + rank

    if len(kept_rows):
        # kept rows come in long contiguous runs (row insertion/removal
        # shifts whole suffixes), and consecutive kept rows with
        # consecutive old rows own contiguous CSR ranges on both sides —
        # copy per run at memcpy speed, falling back to one flat fancy
        # gather when the run structure degenerates
        brk = np.flatnonzero(
            (np.diff(kept_rows) != 1) | (np.diff(src_rows) != 1)
        ) + 1
        if len(brk) + 1 <= max(1024, len(kept_rows) // 8):
            seg = np.concatenate(([0], brk, [len(kept_rows)]))
            for s0, s1 in zip(seg[:-1].tolist(), seg[1:].tolist()):
                d0 = int(start[kept_rows[s0]])
                o0 = int(old.start[src_rows[s0]])
                L = int(start[kept_rows[s1 - 1]] + counts[kept_rows[s1 - 1]]) - d0
                nbr_pos[d0:d0 + L] = pos_old_to_new[old.nbr_pos[o0:o0 + L]]
                nbr_cell[d0:d0 + L] = old.nbr_cell[o0:o0 + L]
                offset[d0:d0 + L] = old.offset[o0:o0 + L]
                slot[d0:d0 + L] = old.slot[o0:o0 + L]
        else:
            src_idx, dst_idx = _ranges(kept_rows, old.start[src_rows])
            nbr_pos[dst_idx] = pos_old_to_new[old.nbr_pos[src_idx]]
            nbr_cell[dst_idx] = old.nbr_cell[src_idx]
            offset[dst_idx] = old.offset[src_idx]
            slot[dst_idx] = old.slot[src_idx]
    if len(fresh_rows):
        src_idx, dst_idx = _ranges(fresh_rows, fresh.start[:-1])
        nbr_pos[dst_idx] = fresh.nbr_pos[src_idx]
        nbr_cell[dst_idx] = fresh.nbr_cell[src_idx]
        offset[dst_idx] = fresh.offset[src_idx]
        slot[dst_idx] = fresh.slot[src_idx]
    return NeighborLists(
        start=start, nbr_pos=nbr_pos, nbr_cell=nbr_cell, offset=offset,
        slot=slot,
    )


def invert_neighbors(n_cells: int, lists: NeighborLists) -> tuple[np.ndarray, np.ndarray]:
    """Unique inverse relation: for each leaf, the leaves that list it in
    their neighbors-of (= reference ``find_neighbors_to`` with offsets
    dropped, which the reference also reports as all-zero and unique —
    ``dccrg.hpp:4693-4706``).

    Returns CSR ``(start, src_pos)`` over all ``n_cells`` leaves, where
    ``src_pos[start[j]:start[j+1]]`` are positions of cells having leaf j as
    a neighbor, sorted ascending.
    """
    from ..utils.setops import counts_to_start, unique_pairs

    n_src = len(lists.start) - 1
    src = np.repeat(np.arange(n_src, dtype=np.int64), np.diff(lists.start))
    nbr_u, src_u = unique_pairs(lists.nbr_pos, src, max(n_src, 1))
    start = counts_to_start(nbr_u, n_cells)
    return start, src_u
