"""Cell-by-cell adaptive mesh refinement: request queues and the commit
pipeline.

Reproduces the semantics of the reference's AMR engine — request API
(``refine_completely``/``unrefine_completely``/``dont_refine``/
``dont_unrefine``, ``dccrg.hpp:2434-2784``) and the ordered commit pipeline
of ``stop_refining`` (``dccrg.hpp:3461-3485``):

1. ``override_refines`` — spread dont_refine vetoes to finer neighbors to a
   fixed point, then drop vetoed refines (``dccrg.hpp:9991-10094``);
2. ``induce_refines`` — add coarser neighbors of refined cells until the
   2:1 balance fixed point (``dccrg.hpp:9591-9767``);
3. ``override_unrefines`` — cancel unrefines conflicting with refines,
   vetoes, or nearby finer cells (``dccrg.hpp:9796-9985``);
4. ``execute`` — replace refined cells with their 8 children and unrefined
   sibling families with their parents (``dccrg.hpp:10104-10554``).

Where the reference iterates MPI collectives (``all_to_all_set`` rounds,
``All_Gather`` consensus), this implementation runs the same fixed points as
vectorized set operations over the replicated host-side leaf directory —
the single-controller equivalent of "every rank reaches the same answer".

A copy of the JAX package's ``amr/refinement.py`` (numpy only), its
``amr.*`` commit counters included.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.mapping import Mapping
from ..core.neighbors import LeafSet, find_all_neighbors
from ..utils.setops import csr_take, unique_u64

__all__ = ["AmrQueues", "AdaptationDelta", "commit_adaptation"]


@dataclass(frozen=True)
class AdaptationDelta:
    """The touched set of one AMR commit — the seed the incremental
    epoch rebuild (``parallel/epoch_delta.py``) patches around.  Unlike
    ``stop_refining``'s return values (children created / family cells
    removed), this is the COMPLETE leaf-set symmetric difference: it also
    carries the refined cells that stopped being leaves and the parents
    that became leaves through unrefinement."""

    added: np.ndarray    # (A,) uint64, sorted: ids newly in the leaf set
    removed: np.ndarray  # (B,) uint64, sorted: ids no longer leaves

    @classmethod
    def empty(cls) -> "AdaptationDelta":
        return cls(
            added=np.zeros(0, dtype=np.uint64),
            removed=np.zeros(0, dtype=np.uint64),
        )


@dataclass
class AmrQueues:
    to_refine: set = field(default_factory=set)
    to_unrefine: set = field(default_factory=set)
    not_to_refine: set = field(default_factory=set)
    not_to_unrefine: set = field(default_factory=set)

    def clear(self):
        self.to_refine.clear()
        self.to_unrefine.clear()
        self.not_to_refine.clear()
        self.not_to_unrefine.clear()


def _symmetric_adjacency(n_cells: int, hood) -> tuple[np.ndarray, np.ndarray]:
    """CSR adjacency of neighbors_of ∪ neighbors_to (both directions) over
    leaf positions — the edge set both fixed points walk."""
    from ..utils.setops import counts_to_start, unique_pairs

    counts = np.diff(hood.lists.start)
    src = np.repeat(np.arange(n_cells, dtype=np.int64), counts)
    nbr = hood.lists.nbr_pos
    a, b = unique_pairs(
        np.concatenate([src, nbr]),
        np.concatenate([nbr, src]),
        max(n_cells, 1),
    )
    start = counts_to_start(a, n_cells)
    return start, b


def override_refines(
    leaves: LeafSet, lvl: np.ndarray, adj: tuple, queues: AmrQueues
) -> set:
    """Spread dont_refine vetoes to strictly finer neighbors until a fixed
    point, then drop vetoed refines.  Returns the final veto set."""
    start, nbr = adj
    dont = np.zeros(len(leaves), dtype=bool)
    seed = leaves.position(np.fromiter(queues.not_to_refine, dtype=np.uint64, count=len(queues.not_to_refine)))
    dont[seed[seed >= 0]] = True
    frontier = np.flatnonzero(dont)
    while len(frontier):
        # all neighbors of the frontier with larger refinement level
        counts = start[frontier + 1] - start[frontier]
        srcs = np.repeat(frontier, counts)
        nbrs = csr_take(start, nbr, frontier)
        finer = nbrs[(lvl[nbrs] > lvl[srcs]) & ~dont[nbrs]]
        frontier = unique_u64(finer.astype(np.uint64)).astype(np.int64)
        dont[frontier] = True

    vetoed = set(leaves.cells[dont].tolist())
    queues.to_refine -= vetoed
    queues.not_to_refine = vetoed
    return vetoed


def induce_refines(leaves: LeafSet, lvl: np.ndarray, adj: tuple, queues: AmrQueues):
    """2:1 balance fixed point: every neighbor (of or to) of a refined cell
    with a smaller refinement level must also refine."""
    start, nbr = adj
    refine = np.zeros(len(leaves), dtype=bool)
    seed = leaves.position(np.fromiter(queues.to_refine, dtype=np.uint64, count=len(queues.to_refine)))
    refine[seed[seed >= 0]] = True
    frontier = np.flatnonzero(refine)
    while len(frontier):
        counts = start[frontier + 1] - start[frontier]
        srcs = np.repeat(frontier, counts)
        nbrs = csr_take(start, nbr, frontier)
        coarser = nbrs[(lvl[nbrs] < lvl[srcs]) & ~refine[nbrs]]
        frontier = unique_u64(coarser.astype(np.uint64)).astype(np.int64)
        refine[frontier] = True
    queues.to_refine = set(leaves.cells[refine].tolist())


def one_per_family(mapping: Mapping, to_unrefine) -> np.ndarray:
    """The unrefine queue with one entry a sibling family, its smallest
    id, sorted.  One process queues one sibling a family
    (``Grid.unrefine_completely`` returns early for a queued family), but
    the union of several controllers' queues, a caller's
    ``unrefine_completely_many`` or a queue set directly may hold more, and
    the commit builds one parent an entry."""
    cand = np.sort(np.fromiter(to_unrefine, dtype=np.uint64, count=len(to_unrefine)))
    _, first = np.unique(mapping.get_parent(cand), return_index=True)
    return cand[np.sort(first)]


def override_unrefines(
    mapping: Mapping, topology, leaves: LeafSet, lvl: np.ndarray, hood_offsets, queues: AmrQueues
):
    """Cancel unrefines whose sibling family conflicts with refines/vetoes,
    or whose would-be parent would sit next to too-fine cells.  The
    reference walks the face backbone around each candidate
    (``dccrg.hpp:9838-9891``); here the same checked set is built directly:
    the would-be parent's neighborhood slots, resolved against the leaf set
    with deeper-than-one-level refinement showing up as unresolved finer
    expansions."""
    if not queues.to_unrefine:
        queues.to_unrefine = set()
        return
    cand = one_per_family(mapping, queues.to_unrefine)
    keep = np.ones(len(cand), dtype=bool)

    sib = mapping.get_siblings(cand)                     # (M, 8)
    parents = mapping.get_parent(cand)
    refine_ids = np.fromiter(queues.to_refine, dtype=np.uint64, count=len(queues.to_refine))
    noun_ids = np.fromiter(
        queues.not_to_unrefine, dtype=np.uint64, count=len(queues.not_to_unrefine)
    )
    conflict = np.isin(sib, refine_ids).any(axis=1) | np.isin(sib, noun_ids).any(axis=1)
    keep &= ~conflict

    # parent-region check: run the neighbor search with the parents as
    # sources (they are not leaves; only their index arithmetic is used)
    if keep.any():
        pl = mapping.get_refinement_level(parents)
        plists = _find_for_nonleaves(
            mapping, topology, leaves, parents[keep], hood_offsets
        )
        child_lvl = pl[keep] + 1
        m = np.flatnonzero(keep)
        refine_pos = leaves.position(refine_ids)
        refine_mask = np.zeros(len(leaves) + 1, dtype=bool)
        refine_mask[refine_pos[refine_pos >= 0]] = True
        for i, pi in enumerate(m):
            sl = slice(plists.start[i], plists.start[i + 1])
            pos = plists.nbr_pos[sl]
            # unresolved finer expansion = leaves more than one level finer
            # than the parent -> too small next to the would-be parent
            if (pos < 0).any():
                keep[pi] = False
                continue
            # same-size-as-candidate neighbor that will be refined
            n_lvl = lvl[pos]
            if (refine_mask[pos] & (n_lvl == child_lvl[i])).any():
                keep[pi] = False

    queues.to_unrefine = set(cand[keep].tolist())


def _find_for_nonleaves(mapping, topology, leaves, cells, hood_offsets):
    """find_all_neighbors for source cells that are not leaves (would-be
    parents): same slot search, non-strict so deeper refinement surfaces as
    nbr_pos == -1."""
    return find_all_neighbors(
        mapping, topology, leaves, np.asarray(hood_offsets, dtype=np.int64),
        source_cells=cells, strict=False,
    )


def commit_adaptation(grid) -> tuple[np.ndarray, np.ndarray, AdaptationDelta]:
    """Run the full stop_refining pipeline on a grid; returns
    (new_cells, removed_cells, delta) and updates the grid's leaf set —
    ``delta`` is the complete touched set (:class:`AdaptationDelta`)
    consumed by the incremental epoch rebuild.  Children stay on the
    refined cell's device; a parent created by unrefinement goes to the
    owner of its first child (``dccrg.hpp:10263-10445``)."""
    mapping: Mapping = grid.mapping
    leaves: LeafSet = grid.leaves
    queues: AmrQueues = grid.amr
    hood = grid.epoch.hoods[None]
    lvl = mapping.get_refinement_level(leaves.cells)

    from ..obs.registry import metrics

    adj = _symmetric_adjacency(len(leaves), hood)
    override_refines(leaves, lvl, adj, queues)
    requested_refines = len(queues.to_refine)
    induce_refines(leaves, lvl, adj, queues)
    # refines added by the 2:1 fixed point beyond the surviving requests
    # = balance violations the commit repaired
    induced_refines = len(queues.to_refine) - requested_refines
    override_unrefines(mapping, grid.topology, leaves, lvl, hood.offsets, queues)

    refined = np.fromiter(queues.to_refine, dtype=np.uint64, count=len(queues.to_refine))
    refined.sort()
    unrefined = np.fromiter(
        queues.to_unrefine, dtype=np.uint64, count=len(queues.to_unrefine)
    )
    unrefined.sort()

    if metrics.enabled:
        metrics.inc("amr.commits")
        metrics.inc("amr.cells_refined", len(refined))
        metrics.inc("amr.families_unrefined", len(unrefined))
        metrics.inc("amr.induced_refines", induced_refines)

    if not len(refined) and not len(unrefined):
        # nothing survived the override passes: the leaf set is untouched,
        # skip rebuilding (and re-sorting) all N leaves
        queues.clear()
        empty = np.zeros(0, dtype=np.uint64)
        return empty, empty.copy(), AdaptationDelta.empty()

    # --- build the new leaf set
    new_children = mapping.get_all_children(refined).reshape(-1) if len(refined) else np.zeros(0, np.uint64)
    removed_families = mapping.get_siblings(unrefined) if len(unrefined) else np.zeros((0, 8), np.uint64)
    removed_cells = removed_families.reshape(-1)
    new_parents = mapping.get_parent(unrefined) if len(unrefined) else np.zeros(0, np.uint64)

    pos_refined = leaves.position(refined)
    owner_refined = leaves.owner[pos_refined] if len(refined) else np.zeros(0, np.int32)
    # parent owner = owner of first child in the family
    first_child = removed_families[:, 0] if len(unrefined) else np.zeros(0, np.uint64)
    owner_parents = (
        leaves.owner[leaves.position(first_child)] if len(unrefined) else np.zeros(0, np.int32)
    )

    drop = set(refined.tolist()) | set(removed_cells.tolist())
    keep_mask = ~np.isin(leaves.cells, np.fromiter(drop, dtype=np.uint64, count=len(drop))) if drop else np.ones(len(leaves), bool)

    cells = np.concatenate([
        leaves.cells[keep_mask],
        new_children,
        new_parents,
    ])
    owners = np.concatenate([
        leaves.owner[keep_mask],
        np.repeat(owner_refined, 8).astype(np.int32),
        owner_parents.astype(np.int32),
    ])
    order = np.argsort(cells)
    grid.leaves = LeafSet(cells=cells[order], owner=owners[order])

    # inherit weights/pins of refined cells to their children; drop state of
    # removed cells (reference inherits pins/weights, dccrg.hpp:10173-10261)
    for table in (grid.cell_weights, grid.pin_requests):
        for parent_id, children in zip(refined.tolist(), mapping.get_all_children(refined).tolist() if len(refined) else []):
            if parent_id in table:
                v = table.pop(parent_id)
                for ch in children:
                    table[ch] = v
        for rc in removed_cells.tolist():
            table.pop(rc, None)

    queues.clear()
    delta = AdaptationDelta(
        added=np.sort(np.concatenate([new_children, new_parents])),
        removed=np.sort(np.concatenate([refined, removed_cells])),
    )
    return np.sort(new_children), np.sort(removed_cells), delta
