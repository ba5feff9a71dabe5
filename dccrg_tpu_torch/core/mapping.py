"""Cell-ID algebra: the bijection cell id <-> (refinement level, 3-D indices).

TPU-native re-design of the reference's ``dccrg_mapping.hpp`` (see
``/root/reference/dccrg_mapping.hpp:153-502``).  Where the reference exposes
scalar methods on a ``Mapping`` class, this module exposes **vectorized**
functions over numpy ``uint64`` arrays — cells are rows of arrays, not
objects — so the whole grid's bookkeeping is done with array ops that can be
reused from both the host metadata path and (via the identical integer
semantics) jittable JAX code.

Id scheme (semantics identical to the reference, which defines file-format
and cross-checking compatibility):

* Ids are 1-based; 0 (``ERROR_CELL``) marks a non-existing cell.
* ``indices`` are 3-D integer coordinates measured at the *maximum* refinement
  level resolution, i.e. a level-``l`` cell covers ``2**(max_ref_lvl - l)``
  index units per dimension.
* All level-``l`` ids occupy one contiguous block placed after every coarser
  level's block; the block for level ``l`` holds ``lx*ly*lz * 8**l`` ids,
  ordered x-fastest (reference ``dccrg_mapping.hpp:180-207``).
* The maximum possible refinement level is bounded by the uint64 id budget
  (reference ``dccrg_mapping.hpp:316-329``).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from functools import cached_property

import numpy as np

__all__ = [
    "ERROR_CELL",
    "ERROR_INDEX",
    "Mapping",
]

#: Indicates a non-existing cell or an error when dealing with cells.
ERROR_CELL = np.uint64(0)

#: Indicates a non-existing index or an error when dealing with indices.
ERROR_INDEX = np.uint64(0xFFFFFFFFFFFFFFFF)

_U64 = np.uint64
_ONE = np.uint64(1)


def _as_u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


@dataclass(frozen=True)
class Mapping:
    """Immutable cell-id mapping for a grid of ``length`` level-0 cells with
    cells refined up to ``max_refinement_level`` times.

    All query methods are vectorized: they accept scalars or arrays of cell
    ids / index triplets and return arrays of matching shape.  Invalid inputs
    yield ``ERROR_CELL`` / ``ERROR_INDEX`` / level ``-1`` rather than raising,
    mirroring the reference's sentinel conventions
    (``dccrg_mapping.hpp:37-40``).
    """

    length: tuple[int, int, int] = (1, 1, 1)
    max_refinement_level: int = 0

    def __post_init__(self):
        lx, ly, lz = (int(v) for v in self.length)
        if lx < 1 or ly < 1 or lz < 1:
            raise ValueError(f"grid length must be >= 1 per dimension: {self.length}")
        object.__setattr__(self, "length", (lx, ly, lz))
        # Overflow guard equivalent to Grid_Length::set (dccrg_length.hpp:81-134):
        # the full id space must fit in uint64.
        if lx * ly * lz >= 2**64:
            raise ValueError(f"grid too large for uint64 ids: {self.length}")
        mrl = int(self.max_refinement_level)
        if mrl < 0:
            raise ValueError("max_refinement_level must be >= 0")
        if mrl > self.max_possible_refinement_level():
            raise ValueError(
                f"max_refinement_level {mrl} exceeds maximum possible "
                f"{self.max_possible_refinement_level()} for grid {self.length}"
            )
        object.__setattr__(self, "max_refinement_level", mrl)

    # ------------------------------------------------------------------ sizes

    @cached_property
    def _level_sizes(self) -> np.ndarray:
        """Number of ids per refinement level: lx*ly*lz * 8**l."""
        l0 = self.length[0] * self.length[1] * self.length[2]
        return _as_u64([l0 * 8**l for l in range(self.max_refinement_level + 1)])

    @cached_property
    def _level_offsets(self) -> np.ndarray:
        """First id of each level block (1-based), length max_ref+2; the last
        entry is ``last_cell + 1``."""
        offs = np.empty(self.max_refinement_level + 2, dtype=np.uint64)
        offs[0] = 1
        np.cumsum(self._level_sizes, out=offs[1:])
        offs[1:] += _ONE
        return offs

    @property
    def last_cell(self) -> np.uint64:
        """Last valid cell id (reference ``dccrg_mapping.hpp:640-648``)."""
        return np.uint64(self._level_offsets[-1] - _ONE)

    def max_possible_refinement_level(self) -> int:
        """Largest max_refinement_level whose id space fits in uint64
        (reference ``dccrg_mapping.hpp:316-329``)."""
        grid_length = self.length[0] * self.length[1] * self.length[2]
        total, lvl = 0, 0
        while True:
            total += grid_length * 8**lvl
            if total > 2**64 - 1:
                return lvl - 1
            lvl += 1
            if lvl > 21:  # uint64 budget bound; 8**21 * 1 > 2**63
                return 21

    @property
    def length_in_indices(self) -> tuple[int, int, int]:
        """Grid extent in index units (max-refinement-level resolution)."""
        s = 1 << self.max_refinement_level
        return (self.length[0] * s, self.length[1] * s, self.length[2] * s)

    # -------------------------------------------------------------- id -> ...

    def get_refinement_level(self, cells) -> np.ndarray:
        """Refinement level of given cell(s); -1 for invalid ids
        (reference ``dccrg_mapping.hpp:261-289``)."""
        cells = _as_u64(cells)
        # searchsorted over the level-block offsets: level l iff
        # offsets[l] <= id < offsets[l+1]
        lvl = np.searchsorted(self._level_offsets, cells, side="right").astype(np.int64) - 1
        invalid = (cells == ERROR_CELL) | (cells > self.last_cell)
        return np.where(invalid, np.int64(-1), lvl)

    def get_indices(self, cells):
        """Indices (at max-ref resolution) of given cell(s).

        Returns an array of shape ``cells.shape + (3,)``; invalid cells get
        ``ERROR_INDEX`` (reference ``dccrg_mapping.hpp:217-253``).
        """
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = lvl >= 0
        lvl_c = np.where(valid, lvl, 0)
        offs = self._level_offsets[lvl_c]
        local = np.where(valid, cells - offs, _U64(0))  # 0-based within level block

        lx = _as_u64(self.length[0]) << lvl_c.astype(np.uint64)
        ly = _as_u64(self.length[1]) << lvl_c.astype(np.uint64)
        scale = _ONE << _as_u64(self.max_refinement_level - lvl_c)

        ix = (local % lx) * scale
        iy = ((local // lx) % ly) * scale
        iz = (local // (lx * ly)) * scale

        out = np.stack([ix, iy, iz], axis=-1)
        out[~np.broadcast_to(valid[..., None], out.shape)] = ERROR_INDEX
        return out

    def get_cell_length_in_indices(self, cells) -> np.ndarray:
        """Edge length of given cell(s) in index units; ``ERROR_INDEX`` for
        invalid cells (reference ``dccrg_mapping.hpp:297-310``)."""
        lvl = self.get_refinement_level(cells)
        out = _ONE << np.where(lvl >= 0, self.max_refinement_level - lvl, 0).astype(np.uint64)
        return np.where(lvl >= 0, out, ERROR_INDEX)

    # -------------------------------------------------------------- ... -> id

    def get_cell_from_indices(self, indices, refinement_level) -> np.ndarray:
        """Cell id of given refinement level at given indices; ``ERROR_CELL``
        for out-of-range inputs (reference ``dccrg_mapping.hpp:153-208``).

        ``indices``: (..., 3) uint64 array at max-ref resolution.
        ``refinement_level``: scalar or (...) int array.
        """
        indices = _as_u64(indices)
        lvl = np.asarray(refinement_level, dtype=np.int64)
        lvl_b = np.broadcast_to(lvl, indices.shape[:-1])

        nx, ny, nz = self.length_in_indices
        in_range = (
            (indices[..., 0] < _U64(nx))
            & (indices[..., 1] < _U64(ny))
            & (indices[..., 2] < _U64(nz))
            & (lvl_b >= 0)
            & (lvl_b <= self.max_refinement_level)
        )
        lvl_c = np.where(in_range, lvl_b, 0).astype(np.uint64)
        indices = np.where(in_range[..., None], indices, _U64(0))

        scale = _ONE << (_as_u64(self.max_refinement_level) - lvl_c)
        ix = indices[..., 0] // scale
        iy = indices[..., 1] // scale
        iz = indices[..., 2] // scale
        lx = _as_u64(self.length[0]) << lvl_c
        ly = _as_u64(self.length[1]) << lvl_c

        cell = self._level_offsets[lvl_c.astype(np.int64)] + ix + iy * lx + iz * lx * ly
        return np.where(in_range, cell, ERROR_CELL)

    # ------------------------------------------------------------- tree ops

    def get_parent(self, cells) -> np.ndarray:
        """Parent id; the cell itself at level 0; ``ERROR_CELL`` if invalid
        (reference ``dccrg_mapping.hpp:367-383``)."""
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = lvl >= 0
        parent = self.get_cell_from_indices(
            self.get_indices(np.where(valid, cells, _ONE)),
            np.maximum(lvl - 1, 0),
        )
        return np.where(valid, np.where(lvl == 0, cells, parent), ERROR_CELL)

    def get_child(self, cells) -> np.ndarray:
        """First (smallest-index) child; cell itself at max level;
        ``ERROR_CELL`` if invalid (reference ``dccrg_mapping.hpp:338-356``)."""
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = lvl >= 0
        child = self.get_cell_from_indices(
            self.get_indices(np.where(valid, cells, _ONE)),
            np.minimum(lvl + 1, self.max_refinement_level),
        )
        at_max = lvl >= self.max_refinement_level
        return np.where(valid, np.where(at_max, cells, child), ERROR_CELL)

    def get_all_children(self, cells) -> np.ndarray:
        """All 8 children, shape ``cells.shape + (8,)``; ``ERROR_CELL`` rows
        for cells at max level or invalid ids
        (reference ``dccrg_mapping.hpp:391-441``).

        Child order is x-fastest, then y, then z — matching the reference's
        triple loop so sibling indexing agrees."""
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = (lvl >= 0) & (lvl < self.max_refinement_level)
        lvl_c = np.where(valid, lvl, 0)
        ind = self.get_indices(np.where(valid, cells, _ONE))

        half = _ONE << _as_u64(self.max_refinement_level - (lvl_c + 1))
        # offsets in child order: x fastest
        ox = np.array([0, 1, 0, 1, 0, 1, 0, 1], dtype=np.uint64)
        oy = np.array([0, 0, 1, 1, 0, 0, 1, 1], dtype=np.uint64)
        oz = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=np.uint64)

        cx = ind[..., 0, None] + ox * half[..., None]
        cy = ind[..., 1, None] + oy * half[..., None]
        cz = ind[..., 2, None] + oz * half[..., None]
        child_ind = np.stack([cx, cy, cz], axis=-1)
        children = self.get_cell_from_indices(child_ind, (lvl_c + 1)[..., None])
        children[~np.broadcast_to(valid[..., None], children.shape)] = ERROR_CELL
        return children

    def get_siblings(self, cells) -> np.ndarray:
        """The cell and its 7 siblings (all children of its parent), shape
        ``cells.shape + (8,)``.  For level-0 cells the first entry is the cell
        itself and the rest are ``ERROR_CELL``
        (reference ``dccrg_mapping.hpp:449-470``)."""
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = lvl >= 0
        out = self.get_all_children(self.get_parent(np.where(valid, cells, _ONE)))
        lvl0 = valid & (lvl == 0)
        if np.any(lvl0):
            out[lvl0] = ERROR_CELL
            out[lvl0, 0] = cells[lvl0] if cells.ndim else cells
        out[~valid] = ERROR_CELL
        return out

    # ------------------------------------------------- scalar fast paths
    # Python-int versions of the tree ops for per-cell request APIs
    # (refine/unrefine queues): identical results to the vectorized forms,
    # ~100x cheaper for a single id than numpy broadcasting.

    @cached_property
    def _offsets_int(self):
        return tuple(int(v) for v in self._level_offsets)

    def refinement_level_of(self, cell: int) -> int:
        """Scalar ``get_refinement_level`` (-1 for invalid ids)."""
        offs = self._offsets_int
        if cell < 1 or cell > offs[-1] - 1:
            return -1
        return bisect.bisect_right(offs, cell) - 1

    def siblings_of(self, cell: int) -> list:
        """Scalar ``get_siblings`` as a list of ints (level-0: the cell
        itself followed by seven ``ERROR_CELL`` entries)."""
        lvl = self.refinement_level_of(cell)
        if lvl < 0:
            return [int(ERROR_CELL)] * 8
        if lvl == 0:
            return [cell] + [int(ERROR_CELL)] * 7
        offs = self._offsets_int
        local = cell - offs[lvl]
        lx = self.length[0] << lvl
        ly = self.length[1] << lvl
        x, y, z = local % lx, (local // lx) % ly, local // (lx * ly)
        bx, by, bz = x & ~1, y & ~1, z & ~1
        base = offs[lvl] + bx + by * lx + bz * lx * ly
        return [
            base + dx + dy * lx + dz * lx * ly
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
        ]

    def parent_of(self, cell: int) -> int:
        """Scalar ``get_parent`` (cell itself at level 0, ERROR_CELL if
        invalid)."""
        lvl = self.refinement_level_of(cell)
        if lvl < 0:
            return int(ERROR_CELL)
        if lvl == 0:
            return cell
        offs = self._offsets_int
        local = cell - offs[lvl]
        lx = self.length[0] << lvl
        ly = self.length[1] << lvl
        x, y, z = local % lx, (local // lx) % ly, local // (lx * ly)
        plx = self.length[0] << (lvl - 1)
        ply = self.length[1] << (lvl - 1)
        return offs[lvl - 1] + (x >> 1) + (y >> 1) * plx + (z >> 1) * plx * ply

    def get_level_0_parent(self, cells) -> np.ndarray:
        """Level-0 ancestor (reference ``dccrg_mapping.hpp:479-493``)."""
        cells = _as_u64(cells)
        lvl = self.get_refinement_level(cells)
        valid = lvl >= 0
        p = self.get_cell_from_indices(self.get_indices(np.where(valid, cells, _ONE)), 0)
        return np.where(valid, np.where(lvl == 0, cells, p), ERROR_CELL)

    # ------------------------------------------------------------ file format

    def to_file_bytes(self) -> bytes:
        """Serialized mapping metadata: 3x uint64 length + int32 max ref lvl —
        same logical content as the reference's ``Mapping::write``
        (``dccrg_mapping.hpp:576-613``)."""
        buf = np.asarray(self.length, dtype="<u8").tobytes()
        buf += np.int32(self.max_refinement_level).astype("<i4").tobytes()
        return buf

    FILE_DATA_SIZE = 3 * 8 + 4

    @classmethod
    def from_file_bytes(cls, data: bytes) -> "Mapping":
        length = tuple(int(v) for v in np.frombuffer(data[:24], dtype="<u8"))
        mrl = int(np.frombuffer(data[24:28], dtype="<i4")[0])
        return cls(length=length, max_refinement_level=mrl)
