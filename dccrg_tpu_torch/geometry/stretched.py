"""Stretched Cartesian geometry: arbitrary level-0 cell boundaries per
dimension, vectorized.

TPU-native re-design of the reference's
``dccrg_stretched_cartesian_geometry.hpp:45-828``: level-0 cell boundaries
are given as three monotone coordinate arrays; refined cells subdivide their
level-0 ancestor uniformly in index space, so all per-cell queries reduce to
index arithmetic plus a lookup into the boundary arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.mapping import ERROR_CELL, ERROR_INDEX, Mapping
from ..core.topology import Topology

__all__ = ["StretchedCartesianGeometry"]


@dataclass(frozen=True)
class StretchedCartesianGeometry:
    mapping: Mapping
    topology: Topology = field(default_factory=Topology)
    #: three arrays of level-0 cell boundary coordinates, each of length
    #: mapping.length[d] + 1, strictly increasing
    coordinates: tuple = ()

    geometry_id = 2
    uniform_level0 = False  # per-dimension arbitrary cell boundaries

    def __post_init__(self):
        coords = tuple(np.asarray(c, dtype=np.float64) for c in self.coordinates)
        if len(coords) != 3:
            raise ValueError("coordinates must contain 3 arrays")
        for d, c in enumerate(coords):
            if len(c) != self.mapping.length[d] + 1:
                raise ValueError(
                    f"dimension {d}: need {self.mapping.length[d] + 1} boundary "
                    f"coordinates, got {len(c)}"
                )
            if not (np.diff(c) > 0).all():
                raise ValueError(f"dimension {d}: coordinates must be increasing")
        object.__setattr__(self, "coordinates", coords)

    # ------------------------------------------------------------- grid box

    def get_start(self) -> np.ndarray:
        return np.asarray([c[0] for c in self.coordinates])

    def get_end(self) -> np.ndarray:
        return np.asarray([c[-1] for c in self.coordinates])

    def get_level_0_cell_length(self) -> np.ndarray:
        """Not uniform here; returns the first level-0 cell's size (the
        reference has no such method for stretched grids — provided for
        duck-type compatibility in diagnostics only)."""
        return np.asarray([c[1] - c[0] for c in self.coordinates])

    # ------------------------------------------------------------ per cell

    def _minmax_1d(self, d: int, ind_d: np.ndarray, len_ind: np.ndarray):
        """Min and max coordinate along dimension d for cells starting at
        index ``ind_d`` with edge length ``len_ind`` index units."""
        upl = np.uint64(1) << np.uint64(self.mapping.max_refinement_level)
        c = self.coordinates[d]
        i0 = (ind_d // upl).astype(np.int64)  # level-0 cell index
        frac0 = (ind_d - i0.astype(np.uint64) * upl).astype(np.float64) / float(upl)
        frac1 = (ind_d + len_ind - i0.astype(np.uint64) * upl).astype(np.float64) / float(upl)
        width = c[i0 + 1] - c[i0]
        return c[i0] + frac0 * width, c[i0] + frac1 * width

    def get_min(self, cells) -> np.ndarray:
        ind = self.mapping.get_indices(cells)
        ln = self.mapping.get_cell_length_in_indices(cells)
        bad = ind[..., 0] == ERROR_INDEX
        ind = np.where(bad[..., None], 0, ind)
        ln = np.where(bad, 1, ln)
        out = np.stack(
            [self._minmax_1d(d, ind[..., d], ln)[0] for d in range(3)], axis=-1
        )
        out[bad] = np.nan
        return out

    def get_max(self, cells) -> np.ndarray:
        ind = self.mapping.get_indices(cells)
        ln = self.mapping.get_cell_length_in_indices(cells)
        bad = ind[..., 0] == ERROR_INDEX
        ind = np.where(bad[..., None], 0, ind)
        ln = np.where(bad, 1, ln)
        out = np.stack(
            [self._minmax_1d(d, ind[..., d], ln)[1] for d in range(3)], axis=-1
        )
        out[bad] = np.nan
        return out

    def get_length(self, cells) -> np.ndarray:
        return self.get_max(cells) - self.get_min(cells)

    def get_center(self, cells) -> np.ndarray:
        return 0.5 * (self.get_min(cells) + self.get_max(cells))

    # -------------------------------------------------------- coord queries

    def get_real_coordinate(self, coords) -> np.ndarray:
        coords = np.asarray(coords, dtype=np.float64)
        start, end = self.get_start(), self.get_end()
        span = end - start
        inside = (coords >= start) & (coords <= end)
        wrapped = start + np.mod(coords - start, span)
        periodic = np.asarray(self.topology.periodic, dtype=bool)
        return np.where(inside, coords, np.where(periodic, wrapped, np.nan))

    def get_indices(self, coords) -> np.ndarray:
        coords = self.get_real_coordinate(coords)
        upl = 1 << self.mapping.max_refinement_level
        out = np.empty(coords.shape, dtype=np.uint64)
        bad = np.isnan(coords)
        for d in range(3):
            c = self.coordinates[d]
            x = np.where(bad[..., d], c[0], coords[..., d])
            i0 = np.clip(np.searchsorted(c, x, side="right") - 1, 0, len(c) - 2)
            frac = (x - c[i0]) / (c[i0 + 1] - c[i0])
            sub = np.clip(np.floor(frac * upl), 0, upl - 1).astype(np.uint64)
            out[..., d] = np.uint64(i0) * np.uint64(upl) + sub
        out[bad] = ERROR_INDEX
        return out

    def get_cell(self, refinement_level: int, coords) -> np.ndarray:
        ind = self.get_indices(coords)
        bad = ind[..., 0] == ERROR_INDEX
        cell = self.mapping.get_cell_from_indices(
            np.where(bad[..., None], 0, ind), refinement_level
        )
        return np.where(bad, ERROR_CELL, cell)

    # ---------------------------------------------------------- file format

    def params_to_file_bytes(self) -> bytes:
        return b"".join(np.asarray(c, dtype="<f8").tobytes() for c in self.coordinates)

    @classmethod
    def params_from_file_bytes(cls, data: bytes, mapping: Mapping, topology: Topology):
        coords, off = [], 0
        for d in range(3):
            n = mapping.length[d] + 1
            coords.append(np.frombuffer(data[off : off + 8 * n], dtype="<f8"))
            off += 8 * n
        return cls(mapping=mapping, topology=topology, coordinates=tuple(coords)), off
