"""Fast host-side set operations for epoch rebuilds.

Every structural mutation (AMR commit, load balance) ends in "rebuild all
derived state" (reference ``dccrg.hpp`` §3.4/3.5 tails), which here is
dominated by deduplicating large (a, b) integer pair sets — ghost
requirement pairs, symmetric adjacency edges, inverse neighbor relations.
``np.unique(..., axis=0)`` sorts rows through a void dtype and is the
single biggest cost at scale; packing each pair into one uint64 key and
sorting with the native OpenMP-parallel kernel
(``native/neighbor_kernels.cpp::sort_unique_u64``) is ~10-40x faster.
Numpy remains the transparent fallback.
"""
from __future__ import annotations

import numpy as np

from ..native import native_sort_unique_u64

__all__ = [
    "unique_u64",
    "unique_pairs",
    "csr_take",
    "counts_to_start",
    "ragged_arange",
]


def ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(l)`` for each l in ``lengths`` — the rank of
    every element within its group (vectorized)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lengths) - lengths
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def unique_u64(keys: np.ndarray) -> np.ndarray:
    """Sorted unique values of a uint64 array.  ``keys`` may be clobbered."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = native_sort_unique_u64(keys)
    if out is None:
        return np.unique(keys)
    return out


def unique_pairs(a: np.ndarray, b: np.ndarray, b_base: int) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique (a, b) pairs, returned as two arrays.

    ``b`` values must lie in [0, b_base).  Keys pack as
    ``a << ceil_log2(b_base) | b`` when that fits 64 bits — shift/mask
    pack and unpack are several times faster than u64 multiply/divide at
    the tens-of-millions-of-pairs scale of epoch rebuilds.  (Rounding the
    base up to a power of two keeps the key order identical to
    ``a * b_base + b``: both sort by a then b.)
    """
    a = np.asarray(a)
    b = np.asarray(b)
    shift = max(int(b_base) - 1, 1).bit_length()
    a_max = int(a.max()) if len(a) else 0
    if a_max >= (1 << (63 - shift)):
        # packing would overflow: fall back to row-wise unique (stack in a
        # common integer dtype — mixed int64/uint64 would promote to
        # float64 and corrupt values above 2^53)
        pairs = np.unique(
            np.stack(
                [a.astype(np.uint64), b.astype(np.uint64)], axis=1
            ),
            axis=0,
        )
        return pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    sh = np.uint64(shift)
    keys = (a.astype(np.uint64) << sh) | b.astype(np.uint64)
    keys = unique_u64(keys)
    mask = np.uint64((1 << shift) - 1)
    return (keys >> sh).astype(np.int64), (keys & mask).astype(np.int64)


def counts_to_start(counts_at: np.ndarray, n: int) -> np.ndarray:
    """CSR start array (n+1) from occurrence indices (bincount-based —
    much faster than ``np.add.at``)."""
    start = np.zeros(n + 1, dtype=np.int64)
    if len(counts_at):
        start[1:] = np.bincount(counts_at, minlength=n)
    np.cumsum(start, out=start)
    return start


def csr_take(start: np.ndarray, data: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Concatenate ``data[start[r]:start[r+1]]`` for every r in ``rows``
    without a Python loop."""
    rows = np.asarray(rows, dtype=np.int64)
    counts = start[rows + 1] - start[rows]
    total = int(counts.sum())
    if total == 0:
        return data[:0]
    shift = np.repeat(start[rows] - (np.cumsum(counts) - counts), counts)
    return data[np.arange(total, dtype=np.int64) + shift]
