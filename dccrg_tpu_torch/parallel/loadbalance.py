"""Load balancing: native partitioners playing Zoltan's role.

The reference delegates repartitioning to Zoltan (13 callbacks,
``dccrg.hpp:11672-12262``) and merges the result with user pin requests
(``make_new_partition``, ``dccrg.hpp:8349-8581``).  Here the partitioners
are implemented natively over the replicated leaf directory:

* ``RCB`` — weighted recursive coordinate bisection over cell centers
  (axis-aligned cuts along the widest extent);
* ``RIB`` — weighted recursive inertial bisection: each cut is
  perpendicular to the principal axis of the sub-population's weighted
  inertia tensor, so elongated off-axis distributions split along their
  true long direction (Zoltan's distinct RIB method);
* ``HSFC``/``SFC``/``HILBERT`` — Hilbert space-filling-curve striping with
  weight-balanced cuts (the curve sfc++ gives the reference);
* ``MORTON`` — Z-order striping (cheaper keys, less compact parts);
* ``BLOCK`` — id-order striping (the initial assignment);
* ``GRAPH``/``HYPERGRAPH`` — native seed-and-refine partitioners over the
  leaf adjacency minimizing the halo edge cut / communication volume
  (``parallel/graph.py``), playing Zoltan's ParMETIS/PHG methods;
* ``NONE`` — keep the current owners (the reference treats Zoltan failure
  as expected for NONE, ``dccrg.hpp:7709-7713``).

Partitioning options (``set_partitioning_option``) are honored where they
are meaningful for the native methods: ``IMBALANCE_TOL`` caps the striping
(BLOCK/MORTON/HILBERT) and graph methods' part loads at ``tol * average``
(Zoltan's default 1.1 applies to the graph methods; the striping methods
stay exactly proportional unless the option is set).  The geometric
methods (RCB/RIB/ZSLAB) split by coordinates and ignore it.

Hierarchical partitioning (``dccrg.hpp:5537-5798``) maps the same machinery
onto a device hierarchy: first split cells over groups (e.g. hosts/slices,
DCN level), then within each group (chips on ICI), recursively for every
``add_partitioning_level`` call.

A copy of the JAX package's ``parallel/loadbalance.py`` (numpy only): the owner
arrays are the JAX package's exactly, for every method.
"""
from __future__ import annotations

import warnings

import numpy as np

from .partition import hilbert_partition, morton_partition, weighted_blocks

__all__ = ["compute_partition", "rcb_partition", "rib_partition",
           "RESERVED_OPTIONS"]

#: Zoltan parameters the reference reserves for dccrg itself
#: (``dccrg.hpp:7716-7723``) — ``set_partitioning_option`` /
#: ``add_partitioning_option`` raise on these.
RESERVED_OPTIONS = frozenset({
    "EDGE_WEIGHT_DIM", "NUM_GID_ENTRIES", "NUM_LID_ENTRIES",
    "OBJ_WEIGHT_DIM", "RETURN_LISTS", "NUM_GLOBAL_PARTS",
    "NUM_LOCAL_PARTS", "AUTO_MIGRATE",
})

#: options that ACT on the native partitioners: ``LB_METHOD`` overrides
#: the method (as Zoltan_Set_Param would), ``IMBALANCE_TOL`` caps part
#: loads, ``PHG_CUT_OBJECTIVE`` selects the hypergraph objective
#: (CONNECTIVITY = communication volume, Zoltan's default;
#: HYPEREDGES = edge cut).
_ACTING_OPTIONS = frozenset({"LB_METHOD", "IMBALANCE_TOL",
                             "PHG_CUT_OBJECTIVE"})

#: Zoltan tuning knobs that are meaningful requests but have no effect
#: on the native methods — DOCUMENTED INERT rather than unknown: the
#: native RCB is already deterministic and rectilinear
#: (coordinate-plane cuts), cuts are recomputed per balance (KEEP_CUTS
#: is a Zoltan-side cache), and the debug/check levels have no Zoltan
#: process to configure.
_INERT_OPTIONS = frozenset({
    "RCB_RECTILINEAR_BLOCKS", "RCB_LOCK_DIRECTIONS", "RCB_SET_DIRECTIONS",
    "RCB_REUSE", "AVERAGE_CUTS", "KEEP_CUTS", "REDUCE_DIMENSIONS",
    "DETERMINISTIC", "CHECK_GEOM", "CHECK_GRAPH", "CHECK_HYPERGRAPH",
    "DEBUG_LEVEL", "DEBUG_PROCESSOR", "DEBUG_MEMORY", "TIMER",
    "PHG_OUTPUT_LEVEL", "GRAPH_SYMMETRIZE", "PHG_MULTILEVEL",
    "LB_APPROACH", "MIGRATE_ONLY_PROC_CHANGES",
})

def warn_unknown_option(name) -> None:
    """Warn when an option name is neither acting, documented-inert, nor
    reserved — called at option-set time (``set_partitioning_option`` /
    ``add_partitioning_option``) so a misspelled knob surfaces once per
    user action, at the line that set it."""
    up = str(name).upper()
    if (up not in _ACTING_OPTIONS and up not in _INERT_OPTIONS
            and up not in RESERVED_OPTIONS):
        warnings.warn(
            f"partitioning option {name!r} is not recognized by the "
            "native partitioners and has no effect",
            stacklevel=3,
        )


def rcb_partition(
    centers: np.ndarray, n_parts: int, weights: np.ndarray | None = None
) -> np.ndarray:
    """Weighted recursive coordinate bisection: split the widest extent at
    the weighted part-count-proportional cut, recurse."""
    n = len(centers)
    w = np.ones(n) if weights is None else np.maximum(np.asarray(weights, float), 0.0)
    owner = np.zeros(n, dtype=np.int32)

    def recurse(idx: np.ndarray, parts: int, first: int):
        if parts <= 1 or len(idx) == 0:
            owner[idx] = first
            return
        left_parts = parts // 2
        frac = left_parts / parts
        c = centers[idx]
        dim = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, dim], kind="stable")
        cum = np.cumsum(w[idx][order])
        total = cum[-1]
        if total <= 0:
            cut = int(round(len(idx) * frac))
        else:
            cut = int(np.searchsorted(cum, frac * total))
            cut = min(max(cut, 1), len(idx) - 1)
        recurse(idx[order[:cut]], left_parts, first)
        recurse(idx[order[cut:]], parts - left_parts, first + left_parts)

    recurse(np.arange(n), n_parts, 0)
    return owner


def rib_partition(
    centers: np.ndarray, n_parts: int, weights: np.ndarray | None = None
) -> np.ndarray:
    """Weighted recursive inertial bisection (Zoltan's RIB method, the
    reference's ``LB_METHOD=RIB``): project the sub-population onto the
    principal axis of its weighted inertia (the largest-eigenvalue
    eigenvector of the weighted covariance of the centers), cut at the
    weighted part-count-proportional point, recurse.  Unlike RCB the cut
    planes are not axis-aligned, so a distribution elongated along an
    oblique direction is split across its true long axis."""
    n = len(centers)
    w = (np.ones(n) if weights is None
         else np.maximum(np.asarray(weights, float), 0.0))
    owner = np.zeros(n, dtype=np.int32)

    def principal_axis(c: np.ndarray, wi: np.ndarray) -> np.ndarray:
        tot = wi.sum()
        if tot <= 0:
            wi = np.ones(len(c))
            tot = float(len(c))
        mu = (wi[:, None] * c).sum(axis=0) / tot
        d = c - mu
        cov = (wi[:, None] * d).T @ d
        _vals, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
        axis = vecs[:, -1]
        # deterministic sign (eigh's is arbitrary): first nonzero
        # component positive, so reruns and controllers agree
        nz = np.flatnonzero(np.abs(axis) > 1e-12)
        if len(nz) and axis[nz[0]] < 0:
            axis = -axis
        return axis

    def recurse(idx: np.ndarray, parts: int, first: int):
        if parts <= 1 or len(idx) == 0:
            owner[idx] = first
            return
        left_parts = parts // 2
        frac = left_parts / parts
        c = centers[idx]
        proj = c @ principal_axis(c, w[idx])
        order = np.argsort(proj, kind="stable")
        cum = np.cumsum(w[idx][order])
        total = cum[-1]
        if total <= 0:
            cut = int(round(len(idx) * frac))
        else:
            cut = int(np.searchsorted(cum, frac * total))
        cut = min(max(cut, 1), len(idx) - 1)
        recurse(idx[order[:cut]], left_parts, first)
        recurse(idx[order[cut:]], parts - left_parts, first + left_parts)

    recurse(np.arange(n), n_parts, 0)
    return owner


def compute_partition(
    method: str,
    grid,
    n_parts: int,
    weights: np.ndarray | None,
    options: dict | None = None,
    adjacency: tuple | None = None,
) -> np.ndarray:
    method = (method or "RCB").upper()
    leaves = grid.leaves
    # Zoltan treats parameter names case-insensitively (reference forwards
    # them verbatim to Zoltan_Set_Param) — match that
    options = {str(k).upper(): v for k, v in (options or {}).items()}
    # LB_METHOD as an option overrides the grid's method, as forwarding
    # it to Zoltan_Set_Param would in the reference
    method = str(options.get("LB_METHOD", method)).upper()
    tol = options.get("IMBALANCE_TOL")
    tol = None if tol is None else float(tol)
    if method == "NONE":
        return leaves.owner.copy()
    if method == "BLOCK":
        return weighted_blocks(np.arange(len(leaves)), weights, n_parts, tol)
    if method == "ZSLAB":
        # z-slab by level-0 row, equal rows per part — the ownership the
        # boxed AMR fast path (parallel/boxed.py) requires; restores slab
        # alignment after other balancing methods have scattered it
        mapping = grid.mapping
        nz0 = int(mapping.length[2])
        if nz0 % n_parts != 0:
            raise ValueError(
                f"ZSLAB needs n_parts | nz ({n_parts} !| {nz0})"
            )
        idx = mapping.get_indices(leaves.cells)
        z0 = idx[:, 2].astype(np.int64) >> mapping.max_refinement_level
        return (z0 // (nz0 // n_parts)).astype(np.int32)
    if method == "RCB":
        centers = grid.geometry.get_center(leaves.cells)
        return rcb_partition(centers, n_parts, weights)
    if method == "RIB":
        centers = grid.geometry.get_center(leaves.cells)
        return rib_partition(centers, n_parts, weights)
    if method in ("HSFC", "SFC", "HILBERT"):
        return hilbert_partition(grid.mapping, leaves.cells, n_parts, weights, tol)
    if method == "MORTON":
        return morton_partition(grid.mapping, leaves.cells, n_parts, weights, tol)
    if method in ("GRAPH", "HYPERGRAPH"):
        from .graph import graph_partition

        objective = "volume" if method == "HYPERGRAPH" else "cut"
        phg = str(options.get("PHG_CUT_OBJECTIVE", "")).upper()
        if method == "HYPERGRAPH" and phg:
            # Zoltan PHG vocabulary: CONNECTIVITY = communication volume
            # (its default), HYPEREDGES = plain edge cut
            objective = {"CONNECTIVITY": "volume",
                         "HYPEREDGES": "cut"}.get(phg, objective)
        return graph_partition(
            grid,
            n_parts,
            weights,
            objective=objective,
            imbalance_tol=1.1 if tol is None else tol,
            adjacency=adjacency,
        )
    raise ValueError(f"unknown load balancing method {method!r}")
