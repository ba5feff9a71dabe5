"""Grid topology: per-dimension periodicity.

TPU-native equivalent of the reference's ``dccrg_topology.hpp:37-191``.
Periodic wrapping itself is applied vectorized in the neighbor engine and
geometry; this class only records the flags and (de)serializes them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Topology"]


@dataclass(frozen=True)
class Topology:
    periodic: tuple[bool, bool, bool] = (False, False, False)

    def __post_init__(self):
        p = tuple(bool(v) for v in self.periodic)
        if len(p) != 3:
            raise ValueError("periodic must have 3 entries")
        object.__setattr__(self, "periodic", p)

    def is_periodic(self, dimension: int) -> bool:
        if not 0 <= dimension < 3:
            raise ValueError(f"invalid dimension {dimension}")
        return self.periodic[dimension]

    # File format: 3x uint8, one per dimension (reference stores periodicity
    # in its checkpoint header, dccrg_topology.hpp:96-170).
    FILE_DATA_SIZE = 3

    def to_file_bytes(self) -> bytes:
        return np.asarray(self.periodic, dtype=np.uint8).tobytes()

    @classmethod
    def from_file_bytes(cls, data: bytes) -> "Topology":
        flags = np.frombuffer(data[:3], dtype=np.uint8)
        return cls(periodic=tuple(bool(v) for v in flags))
