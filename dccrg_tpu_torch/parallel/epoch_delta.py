"""Incremental epoch rebuild: delta-patch derived state after AMR/LB.

``build_epoch`` pays O(N·K) for every structural change, even when a
commit touched a handful of cells — ARCHITECTURE.md's performance model
names that host-side rebuild as THE scaling risk.  The reference library
amortizes it by updating neighbor lists and send/recv info only for
cells whose neighborhoods actually changed after a refinement round
(Honkonen et al. 2013, ``dccrg.hpp`` §3.4/3.5); this module is that
amortization for the epoch design: given the previous ``Epoch`` and the
new leaf/owner snapshot it

1. computes the **affected closure** per registered hood — new/removed
   cells plus one neighborhood radius around them, straight from the old
   CSR relations (``core.neighbors.affected_closure``; no geometric
   search);
2. re-searches neighbors only for the closure and **splices** the
   recomputed CSR ranges into the old forward lists
   (``splice_neighbor_lists``) with a vectorized position remap;
3. patches the inverse CSR (segment splice on the numpy path; the fused
   native pass over the spliced lists otherwise), re-derives ghost
   pairs / inner-outer flags / send-recv schedules from the spliced
   relations, and patches the ``[D, R, Kmax]`` gather tables by row
   gather + per-device row-value remap, re-scattering only the closure
   and migrated rows.

The result is **bit-identical** to a fresh ``build_epoch`` (the full
build stays the semantic oracle): ``DCCRG_EPOCH_VERIFY=1`` cross-checks
every incremental epoch table-by-table against a fresh full build
(``utils.verify.compare_epochs``).

Fallbacks (the caller then runs ``build_epoch``), each counted in
``epoch.delta_fallbacks{reason}``:

* ``fraction`` — the touched closure exceeds
  ``DCCRG_EPOCH_DELTA_MAX_FRACTION`` (default 0.25) of the grid;
* ``r_growth`` — the row budget would grow beyond
  ``DCCRG_EPOCH_DELTA_MAX_R_GROWTH``× (default 1.5) the old ``R``;
* ``dense_flip`` — the dense uniform fast path flips on or off;
* ``device_count`` — the device count differs from the old epoch's;
* ``hoods_changed`` — the registered neighborhood set differs
  (``add_neighborhood``/``remove_neighborhood`` rebuild fully anyway).

Successful patches count ``epoch.delta_builds`` (and
``epoch.delta_builds{kind=amr|lb}``), the closure sizes
``epoch.delta_cells_touched``, recycled table buffers
``epoch.table_pool_reuse``; the patch is the ``epoch.delta_build`` phase
and records the ``epoch.*`` gauges a full build records.
``DCCRG_EPOCH_DELTA=0`` disables the path entirely.

A copy of the JAX package's ``parallel/epoch_delta.py``, its telemetry
included.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.neighbors import (
    LeafSet,
    NeighborLists,
    affected_closure,
    find_all_neighbors,
    splice_neighbor_lists,
)
from .dense import detect_dense
from .epoch import (
    Epoch,
    HoodState,
    _hood_masks,
    _hood_schedule,
    _row_layout,
    record_epoch_gauges,
)
from ..obs.registry import metrics
from .shapes import bucket_k

__all__ = ["build_epoch_delta", "delta_enabled", "FALLBACK_REASONS",
           "TablePool"]

#: the documented fallback reasons (``epoch.delta_fallbacks{reason}``)
FALLBACK_REASONS = (
    "fraction", "r_growth", "dense_flip", "device_count", "hoods_changed",
)


class _DeltaFallback(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def delta_enabled() -> bool:
    return os.environ.get("DCCRG_EPOCH_DELTA", "1") != "0"


class TablePool:
    """Retained gather-table buffer sets, keyed by ``(D, R, Kmax)``.

    A successful delta rebuild frees the old epoch's five per-hood
    ``[D, R, Kmax]`` tables; with sticky bucketed shapes the NEXT delta
    almost always needs buffers of exactly that shape — so the grid
    parks the freed sets here and ``_patch_tables`` re-initializes them
    in place (memset-speed ``fill``) instead of re-allocating.  Bounded
    to a handful of shape keys; holding a set costs the same host memory
    the retired epoch was already using."""

    MAX_SETS = 4

    def __init__(self):
        self._sets: list = []  # [(shape, tables), ...] FIFO

    def put(self, tables: tuple) -> None:
        """Park a freed ``(nbr_rows, nbr_valid, nbr_offset, nbr_len,
        nbr_slot)`` set."""
        if len(self._sets) >= self.MAX_SETS:
            self._sets.pop(0)
        self._sets.append((tables[0].shape, tables))

    def take(self, D: int, R: int, Kmax: int):
        want = (D, R, Kmax)
        for i, (shape, tables) in enumerate(self._sets):
            if shape == want:
                del self._sets[i]
                return tables
        return None


def build_epoch_delta(
    old: Epoch,
    new_leaves: LeafSet,
    n_devices: int,
    neighborhoods: dict,
    *,
    uniform_geometry: bool,
    shape_hints: dict | None = None,
    table_pool: TablePool | None = None,
) -> Epoch | None:
    """Incrementally derive the epoch for ``new_leaves`` from ``old``.

    Returns the patched :class:`Epoch` (bit-identical to a fresh
    ``build_epoch`` given the same ``shape_hints``), or ``None`` after
    recording a fallback reason — the caller then pays the full rebuild.

    ``shape_hints``/``table_pool``: the grid's shape-hysteresis hints
    and recycled table buffers (see ``shapes.py`` / :class:`TablePool`);
    both optional — direct callers get natural buckets and fresh
    allocations.
    """
    if not delta_enabled():
        return None
    try:
        with metrics.phase("epoch.delta_build"):
            epoch, touched, kind = _build_delta_impl(
                old, new_leaves, n_devices, neighborhoods,
                uniform_geometry=uniform_geometry,
                shape_hints=shape_hints, table_pool=table_pool,
            )
    except _DeltaFallback as f:
        metrics.inc("epoch.delta_fallbacks", reason=f.reason)
        return None
    if metrics.enabled:
        metrics.inc("epoch.delta_builds")
        # pure ownership migrations (kind=lb) vs leaf-set changes
        # (kind=amr) — the two take different thresholds and costs
        metrics.inc("epoch.delta_builds", kind=kind)
        metrics.inc("epoch.delta_cells_touched", touched)
        record_epoch_gauges(epoch)
    if os.environ.get("DCCRG_EPOCH_VERIFY", "0") != "0":
        from ..utils.verify import compare_epochs
        from .epoch import build_epoch

        oracle = build_epoch(
            old.mapping, old.topology, new_leaves, n_devices, neighborhoods,
            uniform_geometry=uniform_geometry, shape_hints=shape_hints,
        )
        compare_epochs(epoch, oracle)
    return epoch


def _build_delta_impl(
    old: Epoch,
    new_leaves: LeafSet,
    n_devices: int,
    neighborhoods: dict,
    *,
    uniform_geometry: bool,
    shape_hints: dict | None = None,
    table_pool: TablePool | None = None,
) -> tuple[Epoch, int, str]:
    hints = shape_hints or {}
    # --- cheap structural guards
    if n_devices != old.n_devices:
        raise _DeltaFallback("device_count")
    if set(neighborhoods) != set(old.hoods) or any(
        not np.array_equal(neighborhoods[h], old.hoods[h].offsets)
        for h in neighborhoods
    ):
        raise _DeltaFallback("hoods_changed")
    new_dense = (
        detect_dense(old.mapping, old.topology, new_leaves, n_devices)
        if uniform_geometry else None
    )
    if (old.dense is None) != (new_dense is None):
        raise _DeltaFallback("dense_flip")

    mapping, topology = old.mapping, old.topology
    D = n_devices
    N_old, N_new = len(old.leaves), len(new_leaves)
    new_cells = new_leaves.cells
    owner_new = new_leaves.owner.astype(np.int64)

    old_pos_of_new = old.leaves.position(new_cells)    # (N_new,) -1 = added
    new_pos_of_old = new_leaves.position(old.leaves.cells)  # -1 = removed
    added_new = old_pos_of_new < 0
    removed_old = new_pos_of_old < 0
    surv_new = ~added_new
    migrated_new = np.zeros(N_new, dtype=bool)
    migrated_new[surv_new] = (
        new_leaves.owner[surv_new]
        != old.leaves.owner[old_pos_of_new[surv_new]]
    )
    changed_old_pos = np.flatnonzero(removed_old)
    same_leaves = N_new == N_old and not added_new.any()

    # --- per-hood list/target closure (over OLD positions) + the touched
    # union the fraction threshold and the telemetry counter see
    closures = {}
    touched_new = added_new | migrated_new
    for hid in neighborhoods:
        h = old.hoods[hid]
        if same_leaves:
            lc_old = tc_old = np.zeros(N_old, dtype=bool)
        else:
            lc_old, tc_old = affected_closure(
                h.lists, h.to_start, h.to_src, changed_old_pos, N_old
            )
        closures[hid] = (lc_old, tc_old)
        m = np.zeros(N_new, dtype=bool)
        surv_lc = lc_old & ~removed_old
        m[new_pos_of_old[surv_lc]] = True
        touched_new |= m
    touched = int(touched_new.sum()) + int(removed_old.sum())
    # pure ownership migrations (same_leaves) reuse every neighbor
    # relation, so their real cost at a given touched fraction is far
    # below the AMR case — they get their own, higher threshold so the
    # fast path stays engaged on bigger repartitions
    if same_leaves:
        max_fraction = _env_float("DCCRG_EPOCH_DELTA_MAX_FRACTION_LB", 0.75)
    else:
        max_fraction = _env_float("DCCRG_EPOCH_DELTA_MAX_FRACTION", 0.25)
    if touched > max_fraction * max(N_new, 1):
        raise _DeltaFallback("fraction")

    # --- per-hood: splice forward lists, re-derive inverse/pairs/outer
    hood_raw = {}
    all_pairs = []
    for hid, offsets in neighborhoods.items():
        h = old.hoods[hid]
        lc_old, tc_old = closures[hid]
        if same_leaves:
            # pure ownership migration: the leaf set (hence every
            # neighbor relation) is unchanged — share the old arrays and
            # re-derive only the owner-dependent pieces below
            lists_new = h.lists
            to_start, to_src = h.to_start, h.to_src
            fresh_rows = np.zeros(0, dtype=np.int64)
            pairs_h, is_outer = _pairs_and_outer(
                lists_new, to_start, to_src, owner_new, D, N_new
            )
        else:
            fresh_mask = added_new.copy()
            surv_lc = lc_old & ~removed_old
            fresh_mask[new_pos_of_old[surv_lc]] = True
            fresh_rows = np.flatnonzero(fresh_mask)
            fresh = (
                find_all_neighbors(
                    mapping, topology, new_leaves,
                    np.asarray(offsets, dtype=np.int64),
                    source_cells=new_cells[fresh_rows],
                )
                if len(fresh_rows) else _empty_lists()
            )
            old_row_of_new = np.where(
                surv_new & ~fresh_mask, old_pos_of_new, -1
            )
            lists_new = splice_neighbor_lists(
                h.lists, old_row_of_new, new_pos_of_old, fresh, fresh_rows,
                N_new,
            )
            # the fused native pass re-derives inverse+pairs+outer from
            # the spliced lists in one linear sweep; without it the
            # inverse is spliced too and pairs/outer come from the full
            # build's numpy formula
            from ..native import native_invert_and_pairs

            native = (
                native_invert_and_pairs(
                    lists_new.start, lists_new.nbr_pos, owner_new, D
                ) if D > 1 else None
            )
            if native is not None:
                to_start, to_src, pairs_h, is_outer = native
            else:
                to_start, to_src = _patch_inverse(
                    h, lists_new, lc_old, tc_old, removed_old,
                    new_pos_of_old, old_pos_of_new, fresh_rows, N_new,
                )
                pairs_h, is_outer = _pairs_and_outer(
                    lists_new, to_start, to_src, owner_new, D, N_new
                )
        hood_raw[hid] = (
            offsets, lists_new, to_start, to_src, pairs_h, is_outer,
            fresh_rows,
        )
        all_pairs.append(pairs_h)

    from ..utils.setops import unique_pairs

    if all_pairs:
        cat = np.concatenate(all_pairs, axis=0)
        dev_u, pos_u = unique_pairs(cat[:, 0], cat[:, 1], max(N_new, 1))
        pairs = np.stack([dev_u, pos_u], axis=1)
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)

    # --- row layout (identical code path to the full build)
    epoch, len_all = _row_layout(mapping, topology, new_leaves, D, pairs,
                                 prev_R=hints.get("R"))
    max_r_growth = _env_float("DCCRG_EPOCH_DELTA_MAX_R_GROWTH", 1.5)
    if epoch.R > max_r_growth * old.R:
        raise _DeltaFallback("r_growth")
    epoch.dense = new_dense

    # --- per-hood device tables: schedules/masks re-derived, gather
    # tables patched
    recompute_new = touched_new  # fresh lists OR migrated rows
    for hid, (offsets, lists_new, to_start, to_src, pairs_h, is_outer,
              fresh_rows) in hood_raw.items():
        send_rows, recv_rows, pair_counts = _hood_schedule(epoch, pairs_h)
        inner_mask, outer_mask = _hood_masks(epoch, is_outer)
        rec_mask = recompute_new.copy()
        rec_mask[fresh_rows] = True
        tables = _patch_tables(
            old, old.hoods[hid], epoch, lists_new, len_all, rec_mask,
            old_pos_of_new, new_pos_of_old,
            prev_K=hints.get("K", {}).get(hid), table_pool=table_pool,
        )
        epoch.hoods[hid] = HoodState(
            offsets=offsets,
            lists=lists_new,
            to_start=to_start,
            to_src=to_src,
            send_rows=send_rows,
            recv_rows=recv_rows,
            pair_counts=pair_counts,
            inner_mask=inner_mask,
            outer_mask=outer_mask,
            nbr_rows=tables[0],
            nbr_valid=tables[1],
            nbr_offset=tables[2],
            nbr_len=tables[3],
            nbr_slot=tables[4],
        )
    epoch.delta_built = True
    return epoch, touched, ("lb" if same_leaves else "amr")


def _empty_lists() -> NeighborLists:
    return NeighborLists(
        start=np.zeros(1, dtype=np.int64),
        nbr_pos=np.zeros(0, dtype=np.int64),
        nbr_cell=np.zeros(0, dtype=np.uint64),
        offset=np.zeros((0, 3), dtype=np.int64),
        slot=np.zeros(0, dtype=np.int32),
    )


def _patch_inverse(
    old_hood,
    lists_new: NeighborLists,
    lc_old: np.ndarray,
    tc_old: np.ndarray,
    removed_old: np.ndarray,
    new_pos_of_old: np.ndarray,
    old_pos_of_new: np.ndarray,
    fresh_rows: np.ndarray,
    n_new: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Splice the inverse (neighbors-to) CSR: targets outside the closure
    copy their old segment (sources remapped to new positions — a
    monotone map, so sort order and uniqueness survive); affected targets
    merge their surviving old sources with the re-searched rows'
    contributions through one small ``unique_pairs``."""
    from ..utils.setops import csr_take, ragged_arange, unique_pairs

    to_start, to_src = old_hood.to_start, old_hood.to_src
    surv_new_mask = old_pos_of_new >= 0

    # affected targets (new positions): survivors listed by any closure
    # row, plus everything the re-searched rows now list
    aff = np.zeros(n_new, dtype=bool)
    surv_tc = tc_old & ~removed_old
    aff[new_pos_of_old[surv_tc]] = True
    fresh_counts = (
        lists_new.start[fresh_rows + 1] - lists_new.start[fresh_rows]
    )
    fresh_tgts = csr_take(lists_new.start, lists_new.nbr_pos, fresh_rows)
    aff[fresh_tgts] = True
    aff_rows = np.flatnonzero(aff)

    # merged (target, source) pairs for affected targets only
    old_aff = old_pos_of_new[aff_rows]
    has_old = old_aff >= 0
    rows_o = old_aff[has_old]
    c_o = to_start[rows_o + 1] - to_start[rows_o]
    e_src_old = csr_take(to_start, to_src, rows_o)
    e_tgt = np.repeat(aff_rows[has_old], c_o)
    keep = ~lc_old[e_src_old]  # closure sources re-add via fresh rows
    m_tgt = np.concatenate([e_tgt[keep], fresh_tgts])
    m_src = np.concatenate([
        new_pos_of_old[e_src_old[keep]],
        np.repeat(fresh_rows, fresh_counts),
    ])
    m_tgt, m_src = unique_pairs(m_tgt, m_src, max(n_new, 1))

    counts = np.zeros(n_new, dtype=np.int64)
    un_rows = np.flatnonzero(~aff & surv_new_mask)
    src_rows = old_pos_of_new[un_rows]
    counts[un_rows] = to_start[src_rows + 1] - to_start[src_rows]
    if len(m_tgt):
        counts[: m_tgt.max() + 1] += np.bincount(m_tgt)
    start_new = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(counts, out=start_new[1:])
    src_new = np.empty(int(start_new[-1]), dtype=to_src.dtype)

    if len(un_rows):
        # unaffected targets come in contiguous runs on both sides (same
        # argument as the forward splice): copy+remap per run
        brk = np.flatnonzero(
            (np.diff(un_rows) != 1) | (np.diff(src_rows) != 1)
        ) + 1
        if len(brk) + 1 <= max(1024, len(un_rows) // 8):
            seg = np.concatenate(([0], brk, [len(un_rows)]))
            for s0, s1 in zip(seg[:-1].tolist(), seg[1:].tolist()):
                d0 = int(start_new[un_rows[s0]])
                o0 = int(to_start[src_rows[s0]])
                last = un_rows[s1 - 1]
                L = int(start_new[last] + counts[last]) - d0
                src_new[d0:d0 + L] = new_pos_of_old[to_src[o0:o0 + L]]
        else:
            c_u = counts[un_rows]
            rank = ragged_arange(c_u)
            src_idx = np.repeat(to_start[src_rows], c_u) + rank
            dst_idx = np.repeat(start_new[un_rows], c_u) + rank
            src_new[dst_idx] = new_pos_of_old[to_src[src_idx]]
    if len(m_tgt):
        # merged pairs are sorted by target then source: scatter each
        # target run into its fresh segment
        run_start = np.flatnonzero(
            np.concatenate(([True], m_tgt[1:] != m_tgt[:-1]))
        )
        run_len = np.diff(np.concatenate((run_start, [len(m_tgt)])))
        rank = np.arange(len(m_tgt)) - np.repeat(run_start, run_len)
        src_new[start_new[m_tgt] + rank] = m_src
    return start_new, src_new


def _pairs_and_outer(
    lists: NeighborLists,
    to_start: np.ndarray,
    to_src: np.ndarray,
    owner: np.ndarray,
    n_devices: int,
    n_cells: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Ghost pairs + inner/outer flags for a (lists, inverse, owner)
    triple — the owner-dependent tail re-derived on every delta (the
    relations may be shared with the old epoch; ownership is not).
    Native fused pass when available, else the full build's numpy
    formula (identical output either way)."""
    if n_devices == 1:
        # one device: no edge can be remote — trivially what both the
        # native and numpy passes produce
        return (
            np.zeros((0, 2), dtype=np.int64),
            np.zeros(n_cells, dtype=bool),
        )

    from ..native import native_invert_and_pairs

    native = native_invert_and_pairs(
        lists.start, lists.nbr_pos, owner, n_devices
    )
    if native is not None:
        _, _, pairs, is_outer = native
        return pairs, is_outer

    from ..utils.setops import unique_pairs

    N = n_cells
    src_of = np.repeat(np.arange(N), np.diff(lists.start))
    mask = owner[src_of] != owner[lists.nbr_pos]
    src_to = np.repeat(np.arange(N), np.diff(to_start))
    mask_t = owner[src_to] != owner[to_src]
    dev_u, pos_u = unique_pairs(
        np.concatenate([owner[src_of][mask], owner[src_to][mask_t]]),
        np.concatenate([lists.nbr_pos[mask], to_src[mask_t]]),
        max(N, 1),
    )
    pairs = np.stack([dev_u, pos_u], axis=1)
    is_outer = np.zeros(N, dtype=bool)
    rem = np.flatnonzero(mask)
    is_outer[src_of[rem]] = True
    is_outer[lists.nbr_pos[rem]] = True
    return pairs, is_outer


def _patch_tables(
    old_epoch: Epoch,
    old_hood: HoodState,
    epoch: Epoch,
    lists: NeighborLists,
    len_all: np.ndarray,
    recompute_mask: np.ndarray,
    old_pos_of_new: np.ndarray,
    new_pos_of_old: np.ndarray,
    prev_K: int | None = None,
    table_pool: TablePool | None = None,
):
    """The five ``[D, R, Kmax]`` gather tables by patching: surviving
    unmigrated rows outside the closure copy their old row with
    ``nbr_rows`` values pushed through a per-device old-row -> new-row
    map; closure/fresh/migrated rows re-scatter from the spliced lists.

    Only local rows carry content (ghost/scratch rows are pad in the full
    build too), and row insertions/removals shift surviving rows in long
    contiguous runs — so the copy is run-detected slice assignments
    (memcpy-speed, pad rows never touched), falling back to one fancy
    gather per device when the run structure degenerates.  A native
    fused gather+remap pass takes over when available."""
    from ..utils.setops import ragged_arange

    D, R_new = epoch.n_devices, epoch.R
    R_old = old_epoch.R
    scratch_old, scratch_new = R_old - 1, R_new - 1
    counts = np.diff(lists.start)
    N_new = len(counts)
    Kmax = bucket_k(max(int(counts.max()) if N_new else 1, 1), prev_K)
    Kold = old_hood.nbr_rows.shape[2]
    Kmin = min(Kmax, Kold)

    pooled = (table_pool.take(D, R_new, Kmax)
              if table_pool is not None else None)
    if pooled is not None:
        # recycled destination buffers (in-place patch): re-initialize to
        # the pad values the fresh allocations below would carry — a
        # memset per table instead of five O(D·R·Kmax) allocations
        nbr_rows, nbr_valid, nbr_offset, nbr_len, nbr_slot = pooled
        nbr_rows.fill(scratch_new)
        nbr_valid.fill(False)
        nbr_offset.fill(0)
        nbr_len.fill(0)
        nbr_slot.fill(0)
        metrics.inc("epoch.table_pool_reuse")
    else:
        nbr_rows = np.full((D, R_new, Kmax), scratch_new, dtype=np.int32)
        nbr_valid = np.zeros((D, R_new, Kmax), dtype=bool)
        nbr_offset = np.zeros((D, R_new, Kmax, 3), dtype=np.int32)
        nbr_len = np.zeros((D, R_new, Kmax), dtype=np.int32)
        nbr_slot = np.zeros((D, R_new, Kmax), dtype=np.int32)

    from ..native import native_delta_patch_tables

    for d in range(D):
        lp = epoch.local_pos[d]
        opos = old_pos_of_new[lp]
        reuse = (opos >= 0) & ~recompute_mask[lp]
        dst_rows = np.flatnonzero(reuse)
        src_rows = old_epoch.row_of[opos[reuse]]
        # old-row -> new-row value map on this device: each position that
        # held a row before maps to its new row (scratch if gone)
        rowmap = np.full(R_old, scratch_new, dtype=np.int32)
        old_here = np.concatenate(
            [old_epoch.local_pos[d], old_epoch.ghost_pos[d]]
        )
        if len(old_here):
            np_new = new_pos_of_old[old_here]
            ok = np_new >= 0
            rowmap[np.flatnonzero(ok)] = epoch.rows_on_device(
                d, np_new[ok]
            )
        rowmap[scratch_old] = scratch_new
        if not len(dst_rows):
            continue
        row_counts = counts[lp[dst_rows]]
        if native_delta_patch_tables(
            old_hood.nbr_rows[d], old_hood.nbr_valid[d],
            old_hood.nbr_offset[d], old_hood.nbr_len[d],
            old_hood.nbr_slot[d],
            dst_rows, src_rows, row_counts, rowmap, Kmin,
            nbr_rows[d], nbr_valid[d], nbr_offset[d], nbr_len[d],
            nbr_slot[d],
        ):
            continue
        o_rows, o_valid = old_hood.nbr_rows[d], old_hood.nbr_valid[d]
        o_off, o_len = old_hood.nbr_offset[d], old_hood.nbr_len[d]
        o_slot = old_hood.nbr_slot[d]
        brk = np.flatnonzero(
            (np.diff(dst_rows) != 1) | (np.diff(src_rows) != 1)
        ) + 1
        if len(brk) + 1 <= max(1024, len(dst_rows) // 8):
            # chunk long runs so the per-chunk width tracks the LOCAL
            # widest row — one wide row must not force a whole run of
            # narrow (e.g. level-0) rows to copy at full table width
            chunk = 2048
            bounds = np.unique(np.concatenate(
                [brk, [0, len(dst_rows)],
                 np.arange(0, len(dst_rows), chunk)]
            ))
            seg_start = bounds[:-1]
            seg_end = bounds[1:]
            # everything past a row's neighbor count is pad on both
            # sides: copy only up to the chunk's widest row
            seg_k = np.maximum.reduceat(row_counts, seg_start)
            for s0, s1, k in zip(
                seg_start.tolist(), seg_end.tolist(), seg_k.tolist()
            ):
                a, n = int(dst_rows[s0]), s1 - s0
                c = int(src_rows[s0])
                k = min(int(k), Kmin)
                nbr_rows[d, a:a + n, :k] = rowmap[o_rows[c:c + n, :k]]
                nbr_valid[d, a:a + n, :k] = o_valid[c:c + n, :k]
                nbr_offset[d, a:a + n, :k] = o_off[c:c + n, :k]
                nbr_len[d, a:a + n, :k] = o_len[c:c + n, :k]
                nbr_slot[d, a:a + n, :k] = o_slot[c:c + n, :k]
        else:
            nbr_rows[d, dst_rows, :Kmin] = rowmap[o_rows[src_rows, :Kmin]]
            nbr_valid[d, dst_rows, :Kmin] = o_valid[src_rows, :Kmin]
            nbr_offset[d, dst_rows, :Kmin] = o_off[src_rows, :Kmin]
            nbr_len[d, dst_rows, :Kmin] = o_len[src_rows, :Kmin]
            nbr_slot[d, dst_rows, :Kmin] = o_slot[src_rows, :Kmin]

    rec = np.flatnonzero(recompute_mask)
    if len(rec):
        owner = epoch.leaves.owner.astype(np.int64)
        row_of = epoch.row_of
        c = counts[rec]
        esrc = np.repeat(rec, c)
        ecol = ragged_arange(c)
        idx = np.repeat(lists.start[rec], c) + ecol
        npos = lists.nbr_pos[idx]
        flat = (
            (owner[esrc] * np.int64(R_new) + row_of[esrc]) * np.int64(Kmax)
            + ecol
        )
        edev = owner[esrc]
        nrows = np.empty(len(idx), dtype=np.int64)
        local_e = owner[npos] == edev
        nrows[local_e] = row_of[npos[local_e]]
        rem = np.flatnonzero(~local_e)
        for d in range(D):
            sub = rem[edev[rem] == d]
            if len(sub):
                nrows[sub] = epoch.rows_on_device(d, npos[sub])
        nbr_rows.reshape(-1)[flat] = nrows
        nbr_valid.reshape(-1)[flat] = True
        nbr_offset.reshape(-1, 3)[flat] = lists.offset[idx]
        nbr_len.reshape(-1)[flat] = len_all[npos]
        nbr_slot.reshape(-1)[flat] = lists.slot[idx]
    return nbr_rows, nbr_valid, nbr_offset, nbr_len, nbr_slot
