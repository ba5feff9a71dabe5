"""Cartesian (uniform-cube) geometry, vectorized.

TPU-native re-design of the reference's ``dccrg_cartesian_geometry.hpp:49-768``
and ``dccrg_no_geometry.hpp:55-552``: the same duck-typed query surface
(start/end/length/center/min/max/coordinate->cell, periodic coordinate
wrapping) but every query takes *arrays* of cell ids or coordinates, so
geometry data (dx, centers) can be materialized as device arrays for kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.mapping import ERROR_CELL, ERROR_INDEX, Mapping
from ..core.topology import Topology

__all__ = ["CartesianGeometry", "NoGeometry"]


@dataclass(frozen=True)
class CartesianGeometry:
    """Uniform cells: a start corner plus a level-0 cell size per dimension
    (reference ``Cartesian_Geometry_Parameters``,
    ``dccrg_cartesian_geometry.hpp:49-86``)."""

    mapping: Mapping
    topology: Topology = Topology()
    start: tuple[float, float, float] = (0.0, 0.0, 0.0)
    level_0_cell_length: tuple[float, float, float] = (1.0, 1.0, 1.0)

    geometry_id = 1
    #: every level-0 cell shares one physical size — the capability the
    #: dense/boxed/flat fast paths and the device particle re-bucket
    #: require before trusting get_level_0_cell_length as a global metric
    uniform_level0 = True

    def __post_init__(self):
        object.__setattr__(self, "start", tuple(float(v) for v in self.start))
        lengths = tuple(float(v) for v in self.level_0_cell_length)
        if any(v <= 0 for v in lengths):
            raise ValueError(f"level_0_cell_length must be positive: {lengths}")
        object.__setattr__(self, "level_0_cell_length", lengths)

    # ------------------------------------------------------------- grid box

    def get_start(self) -> np.ndarray:
        return np.asarray(self.start, dtype=np.float64)

    def get_end(self) -> np.ndarray:
        return self.get_start() + np.asarray(self.mapping.length, dtype=np.float64) * np.asarray(
            self.level_0_cell_length, dtype=np.float64
        )

    def get_level_0_cell_length(self) -> np.ndarray:
        return np.asarray(self.level_0_cell_length, dtype=np.float64)

    # ------------------------------------------------------------ per cell

    def _index_unit(self) -> np.ndarray:
        """Physical size of one index unit (max-refinement resolution)."""
        return self.get_level_0_cell_length() / float(1 << self.mapping.max_refinement_level)

    def get_length(self, cells) -> np.ndarray:
        """Cell edge lengths, shape ``cells.shape + (3,)``; NaN for invalid
        ids (reference ``dccrg_cartesian_geometry.hpp:282-309``)."""
        lvl = self.mapping.get_refinement_level(cells)
        valid = lvl >= 0
        scale = np.where(valid, 1.0 / (1 << np.where(valid, lvl, 0)), np.nan)
        return scale[..., None] * self.get_level_0_cell_length()

    def get_min(self, cells) -> np.ndarray:
        """Cell minimum corner coordinates."""
        ind = self.mapping.get_indices(cells)
        bad = ind[..., 0] == ERROR_INDEX
        out = self.get_start() + ind.astype(np.float64) * self._index_unit()
        out[bad] = np.nan
        return out

    def get_center(self, cells) -> np.ndarray:
        """Cell center coordinates; NaN for invalid ids
        (reference ``dccrg_cartesian_geometry.hpp:316-366``)."""
        return self.get_min(cells) + 0.5 * self.get_length(cells)

    def get_max(self, cells) -> np.ndarray:
        return self.get_min(cells) + self.get_length(cells)

    # -------------------------------------------------------- coord queries

    def get_real_coordinate(self, coords) -> np.ndarray:
        """Wrap coordinates into the grid box for periodic dimensions; NaN
        for outside coordinates in non-periodic dimensions
        (reference ``dccrg_cartesian_geometry.hpp:510-565``)."""
        coords = np.asarray(coords, dtype=np.float64)
        start, end = self.get_start(), self.get_end()
        span = end - start
        inside = (coords >= start) & (coords <= end)
        wrapped = start + np.mod(coords - start, span)
        periodic = np.asarray(self.topology.periodic, dtype=bool)
        return np.where(inside, coords, np.where(periodic, wrapped, np.nan))

    def get_indices(self, coords) -> np.ndarray:
        """Indices (max-ref resolution) containing given coordinates;
        ``ERROR_INDEX`` if outside (after periodic wrap)."""
        coords = self.get_real_coordinate(coords)
        unit = self._index_unit()
        rel = (coords - self.get_start()) / unit
        nmax = np.asarray(self.mapping.length_in_indices, dtype=np.float64)
        ok = ~np.isnan(rel)
        idx = np.clip(np.floor(np.where(ok, rel, 0)), 0, nmax - 1).astype(np.uint64)
        return np.where(ok, idx, ERROR_INDEX)

    def get_cell(self, refinement_level: int, coords) -> np.ndarray:
        """Cell of given refinement level at given coordinate(s);
        ``ERROR_CELL`` outside the grid
        (reference ``dccrg_cartesian_geometry.hpp:495-507``)."""
        ind = self.get_indices(coords)
        bad = ind[..., 0] == ERROR_INDEX
        out = self.mapping.get_cell_from_indices(
            np.where(bad[..., None], 0, ind), refinement_level
        )
        return np.where(bad, ERROR_CELL, out)

    # ---------------------------------------------------------- file format

    def params_to_file_bytes(self) -> bytes:
        return (
            np.asarray(self.start, dtype="<f8").tobytes()
            + np.asarray(self.level_0_cell_length, dtype="<f8").tobytes()
        )

    @classmethod
    def params_from_file_bytes(cls, data: bytes, mapping: Mapping, topology: Topology):
        vals = np.frombuffer(data[:48], dtype="<f8")
        return (
            cls(
                mapping=mapping,
                topology=topology,
                start=tuple(vals[:3]),
                level_0_cell_length=tuple(vals[3:6]),
            ),
            48,
        )


class NoGeometry(CartesianGeometry):
    """Trivial geometry: every level-0 cell is a unit cube starting at the
    origin (reference ``dccrg_no_geometry.hpp:55-552``)."""

    geometry_id = 0

    def __init__(self, mapping: Mapping, topology: Topology = Topology(), **_ignored):
        super().__init__(mapping=mapping, topology=topology)

    def params_to_file_bytes(self) -> bytes:
        return b""

    @classmethod
    def params_from_file_bytes(cls, data: bytes, mapping: Mapping, topology: Topology):
        return cls(mapping=mapping, topology=topology), 0
