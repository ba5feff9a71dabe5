"""Cell-to-device partitioning.

Plays the role of the reference's initial striping
(``create_level_0_cells``, ``dccrg.hpp:7967-8102``) and of Zoltan's
repartitioners (``dccrg.hpp:8349-8581``): a partition is just an int32
owner-device array aligned with the sorted leaf-cell array.  Weighted
variants balance user per-cell weights (``dccrg.hpp:6210-6276``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "block_partition",
    "morton_partition",
    "hilbert_partition",
    "weighted_blocks",
]


def weighted_blocks(
    order: np.ndarray,
    weights: np.ndarray | None,
    n_parts: int,
    imbalance_tol: float | None = None,
    nonempty: bool = False,
) -> np.ndarray:
    """Assign cells (in the given traversal order) to ``n_parts`` contiguous
    blocks of near-equal total weight.  Returns owner per cell (original
    order).

    ``imbalance_tol`` plays Zoltan's IMBALANCE_TOL (max part load as a
    multiple of the average, reference ``dccrg.hpp:5537-5564``): when set
    and the proportional cuts violate ``max <= avg * tol``, the cuts are
    recomputed as the minimal-max-load contiguous partition (binary search
    over the block capacity + greedy fill), the classic linear-partition
    repair; the repair is kept only when it strictly lowers the max load.
    ``None`` keeps the plain proportional cuts.

    ``nonempty`` additionally forces the repair whenever the proportional
    cuts leave a part with zero cells (possible with lumpy weights) and
    ``n >= n_parts`` — the repair's greedy fill reserves a cell per
    remaining block, so every part ends up nonempty.
    """
    n = len(order)
    owner = np.empty(n, dtype=np.int32)
    if weights is None:
        # equal-count striping like the reference's block assignment
        counts = np.full(n_parts, n // n_parts, dtype=np.int64)
        counts[: n % n_parts] += 1
        bounds = np.concatenate([[0], np.cumsum(counts)])
        for p in range(n_parts):
            owner[order[bounds[p] : bounds[p + 1]]] = p
        return owner
    w = np.maximum(np.asarray(weights, dtype=np.float64)[order], 0.0)
    cum = np.cumsum(w)
    total = cum[-1] if len(cum) else 0.0
    if total <= 0:
        return weighted_blocks(order, None, n_parts)
    # part p gets cells whose cumulative weight falls in (p/n, (p+1)/n]
    part = np.minimum((cum - w / 2) / total * n_parts, n_parts - 1).astype(np.int32)
    if n_parts > 1:
        loads = np.bincount(part, weights=w, minlength=n_parts)
        over_cap = (
            imbalance_tol is not None
            and loads.max() > imbalance_tol * total / n_parts
        )
        has_empty = (
            nonempty
            and n >= n_parts
            and (np.bincount(part, minlength=n_parts) == 0).any()
        )
        if over_cap or has_empty:
            cand = _min_max_load_blocks(cum, w, n_parts)
            cand_max = np.bincount(cand, weights=w, minlength=n_parts).max()
            if has_empty or cand_max < loads.max():
                part = cand
    owner[order] = part
    return owner


def _capacity_fill(cum: np.ndarray, cap: float, n_parts: int) -> np.ndarray | None:
    """Greedy fill of contiguous blocks with per-block weight <= cap (each
    block takes at least one cell, and leaves one for every block after it
    so no block runs empty while cells remain).  Returns the block bounds
    (cut indices, len n_parts+1) or None if more than ``n_parts`` blocks
    are needed."""
    n = len(cum)
    bounds = [0]
    start = 0
    for p in range(n_parts):
        if start >= n:
            bounds.append(n)
            continue
        base = cum[start - 1] if start else 0.0
        end = int(np.searchsorted(cum, base + cap, side="right"))
        end = min(end, n - (n_parts - p - 1))  # reserve for later blocks
        end = max(end, start + 1)
        bounds.append(min(end, n))
        start = bounds[-1]
    if bounds[-1] < n:
        return None
    return np.asarray(bounds, dtype=np.int64)


def _min_max_load_blocks(cum: np.ndarray, w: np.ndarray, n_parts: int) -> np.ndarray:
    """Minimal-max-load contiguous partition of the weight sequence: binary
    search the smallest feasible block capacity, then greedy-fill."""
    lo = float(max(w.max(), cum[-1] / n_parts))
    hi = float(cum[-1])
    best = _capacity_fill(cum, hi, n_parts)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        b = _capacity_fill(cum, mid, n_parts)
        if b is None:
            lo = mid
        else:
            hi, best = mid, b
    part = np.zeros(len(w), dtype=np.int32)
    for p in range(n_parts):
        part[best[p] : best[p + 1]] = p
    return part


def block_partition(cells: np.ndarray, n_parts: int, weights=None, imbalance_tol=None) -> np.ndarray:
    """Contiguous id-order striping (the reference's default initial
    assignment)."""
    return weighted_blocks(np.arange(len(cells)), weights, n_parts, imbalance_tol)


def _morton_key(indices: np.ndarray) -> np.ndarray:
    """Interleave bits of 3-D indices into a Morton (Z-order) key."""
    idx = indices.astype(np.uint64)
    key = np.zeros(len(idx), dtype=np.uint64)
    nbits = int(max(1, np.ceil(np.log2(float(idx.max()) + 1)))) if len(idx) else 1
    for b in range(min(nbits, 21)):
        for d in range(3):
            key |= ((idx[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    return key


def morton_partition(mapping, cells: np.ndarray, n_parts: int, weights=None, imbalance_tol=None) -> np.ndarray:
    """Space-filling-curve striping: order leaves along a Morton curve of
    their (center-ish) indices then cut into weight-balanced blocks."""
    ind = mapping.get_indices(cells)
    keys = _morton_key(ind)
    order = np.argsort(keys, kind="stable")
    return weighted_blocks(order, weights, n_parts, imbalance_tol)


def _hilbert_key(indices: np.ndarray, nbits: int) -> np.ndarray:
    """3-D Hilbert-curve key of each index triple, vectorized.

    Skilling's AxestoTranspose (AIP Conf. Proc. 707, 381 (2004)) with the
    per-element branches turned into masked XORs, followed by bit
    interleaving of the transpose-format result.  Fills the role of the
    sfc++ Hilbert ordering the reference uses for its optional SFC initial
    partition (``dccrg.hpp:56-58``, USE_SFC) and of Zoltan's HSFC method.
    Unlike Morton order, consecutive keys are face-adjacent cells, so
    contiguous cuts give compact parts (smaller halo surface).
    """
    X = indices.astype(np.uint64).T.copy()  # (3, n)
    one = np.uint64(1)
    # inverse undo excess work
    Q = one << np.uint64(max(nbits, 1) - 1)
    while Q > one:
        P = Q - one
        for i in range(3):
            hi = (X[i] & Q) != 0
            # branch taken: reflect X[0]
            X[0] ^= np.where(hi, P, np.uint64(0))
            # branch not taken: swap low bits of X[0] and X[i]
            t = np.where(hi, np.uint64(0), (X[0] ^ X[i]) & P)
            X[0] ^= t
            X[i] ^= t
        Q >>= one
    # Gray encode
    X[1] ^= X[0]
    X[2] ^= X[1]
    t = np.zeros_like(X[2])
    Q = one << np.uint64(max(nbits, 1) - 1)
    while Q > one:
        t ^= np.where((X[2] & Q) != 0, Q - one, np.uint64(0))
        Q >>= one
    X ^= t[None, :]
    # transpose format -> scalar key: bit b of axis i lands at 3*b + (2-i)
    key = np.zeros(X.shape[1], dtype=np.uint64)
    for b in range(nbits):
        for i in range(3):
            key |= ((X[i] >> np.uint64(b)) & one) << np.uint64(3 * b + (2 - i))
    return key


def hilbert_partition(
    mapping, cells: np.ndarray, n_parts: int, weights=None, imbalance_tol=None,
    nonempty: bool = False,
) -> np.ndarray:
    """Hilbert space-filling-curve striping: order leaves along a Hilbert
    curve of their max-resolution indices, cut into weight-balanced blocks."""
    ind = mapping.get_indices(cells)
    hi = int(ind.max()) if len(ind) else 0
    nbits = max(1, int(hi).bit_length())
    keys = _hilbert_key(ind, nbits)
    order = np.argsort(keys, kind="stable")
    return weighted_blocks(order, weights, n_parts, imbalance_tol, nonempty)
