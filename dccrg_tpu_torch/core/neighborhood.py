"""Neighborhood offset lists.

Reference semantics: ``dccrg.hpp:7895-7954`` — a neighborhood of length 0 is
the 6 face offsets in the order (0,0,-1),(0,-1,0),(-1,0,0),(1,0,0),(0,1,0),
(0,0,1); length n >= 1 is the full (2n+1)^3 - 1 cube ordered z-outer /
y-middle / x-inner with the origin excluded.  ``neighborhood_to`` is the
negation of every offset.
"""
from __future__ import annotations

import numpy as np

__all__ = ["default_neighborhood", "validate_neighborhood"]

_FACE_OFFSETS = np.array(
    [(0, 0, -1), (0, -1, 0), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
    dtype=np.int64,
)


def default_neighborhood(length: int) -> np.ndarray:
    """Offsets of the default neighborhood of given length, shape (K, 3)."""
    if length < 0:
        raise ValueError("neighborhood length must be >= 0")
    if length == 0:
        return _FACE_OFFSETS.copy()
    r = np.arange(-length, length + 1, dtype=np.int64)
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    offs = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return offs[~(offs == 0).all(axis=1)]


def validate_neighborhood(offsets) -> np.ndarray:
    """Check a user neighborhood: (K,3) int offsets, no origin, no dupes
    (reference add_neighborhood preconditions, ``dccrg.hpp:6383-6450``)."""
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.ndim != 2 or offs.shape[1] != 3:
        raise ValueError("neighborhood offsets must have shape (K, 3)")
    if (offs == 0).all(axis=1).any():
        raise ValueError("neighborhood must not contain the origin")
    if len(np.unique(offs, axis=0)) != len(offs):
        raise ValueError("neighborhood offsets must be unique")
    return offs
