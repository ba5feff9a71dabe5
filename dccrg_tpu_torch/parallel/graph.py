"""Graph / hypergraph partitioning over the leaf adjacency.

Plays the role of Zoltan's GRAPH (ParMETIS-style edge-cut) and
HYPERGRAPH (PHG communication-volume) methods, which the reference feeds
through 13 callbacks (``dccrg.hpp:11807-12142``: per-cell edge lists with
payload-size edge weights for the graph, per-cell hyperedges of the cell
plus its neighbors for the hypergraph).

The native algorithm is seed + refine:

1. **Seed** with the Hilbert-curve striping (already near-minimal surface
   for uniform grids).
2. **Refine** with conflict-free greedy boundary passes: every boundary
   cell proposes a move to the neighbor part that improves the objective
   most; proposals are accepted in gain order, skipping any cell adjacent
   to an already-accepted move (so accepted gains stay exact and each
   sweep strictly improves the objective), subject to the Zoltan
   IMBALANCE_TOL load cap ``max part load <= tol * average``.

Objectives:

* ``"cut"`` (GRAPH) — number of distinct adjacent leaf pairs whose ends
  live on different devices: the halo edge cut.
* ``"volume"`` (HYPERGRAPH) — total number of (cell, remote part) copies
  the halo exchange must ship: Zoltan PHG's connectivity-1 metric.

Scaling note: candidate *selection* is fully vectorized (boundary-
restricted count matrix); the accept loop is per-candidate Python.  For
``"cut"`` it does O(1) work per candidate; ``"volume"``'s exact delta
walks each candidate's neighbors, so very large HYPERGRAPH balances pay
an interpreter cost per boundary cell per sweep — acceptable for the
structural-mutation cadence this is called at, and the place to optimize
first if that changes.

A copy of the JAX package's ``parallel/graph.py`` (numpy only): the owner
arrays are the JAX package's exactly, for every method.
"""
from __future__ import annotations

import numpy as np

from .partition import hilbert_partition

__all__ = [
    "grid_adjacency",
    "restrict_adjacency",
    "edge_cut",
    "comm_volume",
    "graph_partition",
]


def _csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int):
    """Sorted, deduplicated CSR from directed edge lists."""
    key = src.astype(np.int64) * np.int64(n) + dst.astype(np.int64)
    key = np.unique(key)
    src_u = (key // n).astype(np.int64)
    dst_u = (key % n).astype(np.int64)
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_u, minlength=n), out=start[1:])
    return start, dst_u


def grid_adjacency(grid) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric deduplicated CSR adjacency over leaf positions, from the
    default neighborhood's neighbor lists (the same lists the halo
    schedule uses, so the edge cut below IS the halo pair count)."""
    lists = grid.epoch.hoods[None].lists
    n = len(grid.leaves)
    counts = np.diff(lists.start)
    src = np.repeat(np.arange(n, dtype=np.int64), counts)
    dst = lists.nbr_pos.astype(np.int64)
    keep = (dst >= 0) & (dst != src)
    src, dst = src[keep], dst[keep]
    # symmetrize: AMR neighbors-of is not symmetric cell-by-cell
    return _csr_from_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n
    )


def restrict_adjacency(
    start: np.ndarray, nbr: np.ndarray, idx: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Adjacency induced on the subset ``idx`` (renumbered 0..len(idx)-1);
    edges leaving the subset are dropped."""
    n = len(start) - 1
    remap = np.full(n, -1, dtype=np.int64)
    remap[idx] = np.arange(len(idx), dtype=np.int64)
    counts = np.diff(start)
    src = np.repeat(np.arange(n, dtype=np.int64), counts)
    m = (remap[src] >= 0) & (remap[nbr] >= 0)
    return _csr_from_edges(remap[src[m]], remap[nbr[m]], len(idx))


def edge_cut(part: np.ndarray, start: np.ndarray, nbr: np.ndarray) -> int:
    """Undirected edges whose ends are on different parts."""
    counts = np.diff(start)
    src = np.repeat(np.arange(len(start) - 1, dtype=np.int64), counts)
    return int((part[src] != part[nbr]).sum()) // 2


def comm_volume(part: np.ndarray, start: np.ndarray, nbr: np.ndarray) -> int:
    """Total (cell, remote part) copies the halo must ship: for every cell,
    the number of distinct parts among its neighbors other than its own
    (Zoltan PHG connectivity-1)."""
    n = len(start) - 1
    n_parts = int(part.max()) + 1 if n else 1
    counts = np.diff(start)
    src = np.repeat(np.arange(n, dtype=np.int64), counts)
    pair = np.unique(src * np.int64(n_parts) + part[nbr])
    owner_pair = (pair // n_parts).astype(np.int64)
    return int((part[owner_pair] != pair % n_parts).sum())


def _volume_delta(i, a, b, part, cnt, start, nbr):
    """Exact comm-volume change of moving cell i from part a to part b,
    with every other cell fixed (``cnt(j, p)`` = j's neighbor count on
    part p, exact at call time)."""
    delta = int(cnt(i, a) > 0) - int(cnt(i, b) > 0)
    for j in nbr[start[i] : start[i + 1]]:
        pj = part[j]
        if a != pj:
            delta -= int(cnt(j, a) == 1)
        if b != pj:
            delta += int(cnt(j, b) == 0)
    return delta


def graph_partition(
    grid,
    n_parts: int,
    weights: np.ndarray | None = None,
    *,
    objective: str = "cut",
    imbalance_tol: float = 1.1,
    max_sweeps: int = 10,
    adjacency: tuple[np.ndarray, np.ndarray] | None = None,
) -> np.ndarray:
    """Seed-and-refine partitioner minimizing the halo edge cut (GRAPH) or
    communication volume (HYPERGRAPH) under the IMBALANCE_TOL load cap."""
    leaves = grid.leaves
    n = len(leaves)
    # the seed itself carries the load cap and part-nonemptiness:
    # refinement below only ever moves cells into parts with room and
    # never into an empty part (no cell has neighbors there), so an
    # overloaded or empty seed part would otherwise survive
    part = hilbert_partition(
        grid.mapping, leaves.cells, n_parts, weights, imbalance_tol,
        nonempty=True,
    )
    if n_parts <= 1 or n <= n_parts:
        return part
    start, nbr = adjacency if adjacency is not None else grid_adjacency(grid)
    w = (
        np.ones(n)
        if weights is None
        else np.maximum(np.asarray(weights, dtype=np.float64), 0.0)
    )
    cap = imbalance_tol * w.sum() / n_parts
    loads = np.bincount(part, weights=w, minlength=n_parts)
    sizes = np.bincount(part, minlength=n_parts)
    use_volume = objective == "volume"
    deg = np.diff(start)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)

    for _ in range(max_sweeps):
        # only boundary cells (some neighbor on another part) can gain from
        # a move, so the count matrix is restricted to them — O(surface),
        # not O(n), in both memory and scatter time
        cross = part[src] != part[nbr]
        bnd = np.unique(src[cross])
        if not len(bnd):
            break
        nb = len(bnd)
        row_idx = np.full(n, -1, dtype=np.int64)
        row_idx[bnd] = np.arange(nb)
        on_bnd = row_idx[src] >= 0
        counts = np.zeros((nb, n_parts), dtype=np.int32)
        np.add.at(counts, (row_idx[src[on_bnd]], part[nbr[on_bnd]]), 1)
        rows = np.arange(nb)
        own = part[bnd]
        cur = counts[rows, own].copy()
        counts[rows, own] = -1
        best = np.argmax(counts, axis=1)
        gain = counts[rows, best] - cur              # edge-cut improvement
        counts[rows, own] = cur
        # volume mode also screens zero-cut-gain moves: they can still cut
        # comm volume via neighbors' distinct-part counts, and the exact
        # _volume_delta below is the real accept filter
        cand = np.flatnonzero(gain >= 0 if use_volume else gain > 0)
        if not len(cand):
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        dirty = np.zeros(n, dtype=bool)
        # exact neighbor-part counts at any point mid-sweep: boundary rows
        # live in `counts` (updated on accept); an interior cell's row is
        # deg on its own part and 0 elsewhere, plus any overlay deltas from
        # accepted moves next to it
        overlay: dict = {}

        def cnt(j, p):
            r = row_idx[j]
            if r >= 0:
                return int(counts[r, p])
            base = int(deg[j]) if part[j] == p else 0
            return base + overlay.get((int(j), p), 0)

        moved = 0
        for r in cand:
            i = int(bnd[r])
            if dirty[i]:
                continue
            a, b = int(part[i]), int(best[r])
            # a move may fill a part up to the cap, or — when the cap is
            # tighter than what the seed already achieves (tiny parts) —
            # up to the current max load, so refinement never freezes on
            # grids with fewer than 1/(tol-1) cells per part
            if loads[b] + w[i] > max(cap, loads.max()) or sizes[a] <= 1:
                continue
            if use_volume and _volume_delta(i, a, b, part, cnt, start, nbr) >= 0:
                continue
            part[i] = b
            loads[a] -= w[i]
            loads[b] += w[i]
            sizes[a] -= 1
            sizes[b] += 1
            js = nbr[start[i] : start[i + 1]]
            if use_volume:
                # keep neighbor rows exact so later candidates'
                # _volume_delta (which reads 2-hop state) stays correct
                for j in js:
                    rj = row_idx[j]
                    if rj >= 0:
                        counts[rj, a] -= 1
                        counts[rj, b] += 1
                    else:
                        j = int(j)
                        overlay[(j, a)] = overlay.get((j, a), 0) - 1
                        overlay[(j, b)] = overlay.get((j, b), 0) + 1
            # accepted moves must be pairwise non-adjacent so each sweep's
            # gains are exact; mark i's neighborhood as settled this sweep
            dirty[i] = True
            dirty[js] = True
            moved += 1
        if not moved:
            break
    return part.astype(np.int32)
