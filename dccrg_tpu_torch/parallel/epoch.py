"""Partition epoch: every piece of derived distributed state.

The reference rebuilds derived structures (neighbor lists, remote-neighbor
info, send/recv lists, ghost allocations, iterator caches) after every
mutating collective (``dccrg.hpp`` §3.4/3.5 tails).  Here all of that is one
immutable ``Epoch`` object, rebuilt from ``(leaves, neighborhoods)`` after
``balance_load``/``stop_refining`` — and every jitted schedule is keyed by
the epoch so compiled schedules are never rebuilt mid-run.

A copy of the JAX package's ``parallel/epoch.py``, with its telemetry: the
``epoch.build`` / ``epoch.hood_build`` phases, the table-shape gauges
(:func:`record_epoch_gauges`) and a device-memory sample after each build.

Row layout per device: rows ``[0, n_local)`` hold the device's own cells in
ascending id order; rows ``[n_local, n_local + n_ghost)`` hold ghost copies
of remote neighbors in ascending id order; row ``R - 1`` is a scratch row
that absorbs padded gathers/scatters.  ``R`` is uniform across devices so
payloads live as dense ``[D, R, ...]`` arrays sharded over the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.mapping import Mapping
from ..core.topology import Topology
from ..core.neighbors import LeafSet, NeighborLists, find_all_neighbors, invert_neighbors
from ..obs.registry import metrics
from .dense import detect_dense
from .shapes import bucket_k, bucket_rows

__all__ = ["HoodState", "Epoch", "build_epoch", "record_epoch_gauges"]


@dataclass
class HoodState:
    """Per-neighborhood derived state (the default neighborhood and each
    user-added one get their own — reference ``dccrg.hpp:6383-6603``)."""

    offsets: np.ndarray            # (K, 3) neighborhood offsets
    lists: NeighborLists           # neighbors-of over ALL leaves
    to_start: np.ndarray           # inverse CSR (neighbors-to) over all leaves
    to_src: np.ndarray
    # per-device send/recv schedule, aligned pairwise:
    # send_rows[i, j, :] = local rows on i shipped to j (pad = scratch)
    send_rows: np.ndarray          # (D, D, S) int32
    recv_rows: np.ndarray          # (D, D, S) int32: recv_rows[j, i] ghost rows on j from i
    pair_counts: np.ndarray        # (D, D) int64 cells exchanged per pair
    inner_mask: np.ndarray         # (D, R) bool: local cell, no remote neighbor
    outer_mask: np.ndarray         # (D, R) bool: local cell with remote neighbor
    # neighbor gather tables over local rows:
    nbr_rows: np.ndarray           # (D, R, Kmax) int32 row indices (pad = scratch)
    nbr_valid: np.ndarray          # (D, R, Kmax) bool
    nbr_offset: np.ndarray         # (D, R, Kmax, 3) int32 offsets in index units
    nbr_len: np.ndarray            # (D, R, Kmax) int32 neighbor edge length in index units
    nbr_slot: np.ndarray           # (D, R, Kmax) int32 neighborhood-offset index


@dataclass
class Epoch:
    mapping: Mapping
    topology: Topology
    leaves: LeafSet
    n_devices: int
    R: int                         # rows per device incl. ghosts + 1 scratch
    n_local: np.ndarray            # (D,) local cell counts
    n_ghost: np.ndarray            # (D,) ghost counts
    local_pos: list                # per device: (n_local,) global leaf positions
    ghost_pos: list                # per device: (n_ghost,) global leaf positions
    row_of: np.ndarray             # (N,) int32 local row of each leaf on its owner
    cell_len: np.ndarray           # (D, R) int32 cell edge length in index units (0 pad)
    cell_level: np.ndarray         # (D, R) int8 refinement level (-1 pad)
    cell_ids: np.ndarray           # (D, R) uint64 cell id per row (0 pad)
    local_mask: np.ndarray         # (D, R) bool
    hoods: dict = field(default_factory=dict)   # hood id (None = default) -> HoodState
    #: set when the grid qualifies for the dense uniform fast path
    dense = None

    # ------------------------------------------------------------- lookups

    def rows_on_device(self, d: int, pos: np.ndarray) -> np.ndarray:
        """Row on device d for each global leaf position (local or ghost);
        scratch row for positions not present on d."""
        pos = np.asarray(pos, dtype=np.int64)
        out = np.full(len(pos), self.R - 1, dtype=np.int64)
        lp, gp = self.local_pos[d], self.ghost_pos[d]
        if len(lp):
            li_c = np.minimum(np.searchsorted(lp, pos), len(lp) - 1)
            m = lp[li_c] == pos
            out[m] = li_c[m]
        if len(gp):
            gi = np.searchsorted(gp, pos)
            gi_c = np.minimum(gi, len(gp) - 1)
            m = gp[gi_c] == pos
            out[m] = self.n_local[d] + gi_c[m]
        return out

    def global_rows(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(device, row) of each leaf position on its owning device."""
        pos = np.asarray(pos, dtype=np.int64)
        return self.leaves.owner[pos], self.row_of[pos]


def _build_hood(
    mapping: Mapping,
    topology: Topology,
    leaves: LeafSet,
    offsets: np.ndarray,
    n_devices: int,
):
    lists = find_all_neighbors(mapping, topology, leaves, offsets)
    to_start, to_src, pairs, is_outer = _invert_and_pairs(
        lists, leaves, n_devices
    )
    return lists, to_start, to_src, pairs, is_outer


def _invert_and_pairs(lists: NeighborLists, leaves: LeafSet, n_devices: int):
    """(inverse CSR, ghost pairs, inner/outer flags) for a neighbor-list
    set — the owner-dependent tail of a hood build, shared by the full
    build and the incremental delta path (``epoch_delta.py``)."""
    N = len(leaves)
    owner = leaves.owner.astype(np.int64)

    # Fused native pass: inverse CSR + ghost pairs + inner/outer in one
    # cache-friendly sweep (counting buckets instead of an E log E sort)
    from ..native import native_invert_and_pairs

    native = native_invert_and_pairs(lists.start, lists.nbr_pos, owner,
                                     n_devices)
    if native is not None:
        return native

    # --- numpy fallback (semantic source of truth)
    to_start, to_src = invert_neighbors(N, lists)

    # ghost requirement: remote cells in neighbors_of/to of local cells
    from ..utils.setops import unique_pairs

    src_of = np.repeat(np.arange(N), np.diff(lists.start))
    # (device needing, remote pos) from neighbors_of
    mask = owner[src_of] != owner[lists.nbr_pos]
    # from neighbors_to
    src_to = np.repeat(np.arange(N), np.diff(to_start))
    mask_t = owner[src_to] != owner[to_src]
    dev_u, pos_u = unique_pairs(
        np.concatenate([owner[src_of][mask], owner[src_to][mask_t]]),
        np.concatenate([lists.nbr_pos[mask], to_src[mask_t]]),
        max(N, 1),
    )
    pairs = np.stack([dev_u, pos_u], axis=1)
    # inner/outer: a remote edge (i -> j) makes i outer via neighbors_of
    # and j outer via neighbors_to
    is_outer = np.zeros(N, dtype=bool)
    rem = np.flatnonzero(mask)
    is_outer[src_of[rem]] = True
    is_outer[lists.nbr_pos[rem]] = True
    return to_start, to_src, pairs, is_outer


def build_epoch(
    mapping: Mapping,
    topology: Topology,
    leaves: LeafSet,
    n_devices: int,
    neighborhoods: dict,
    *,
    uniform_geometry: bool,
    shape_hints: dict | None = None,
) -> Epoch:
    """Build the complete derived state for a (leaves, owner) snapshot.

    ``neighborhoods``: dict hood-id -> (K,3) offsets; must contain the
    default hood under key ``None``.

    ``uniform_geometry``: whether all level-0 cells share one physical
    size (plain Cartesian).  The dense fast-path consumers read their
    metric factors from ``get_level_0_cell_length``, which is only
    meaningful then — a stretched geometry must not qualify.

    ``shape_hints``: the pre-change epoch's ``{"R": ..., "K": {hood:
    ...}}`` (``shapes.epoch_shape_hints``) — bucket hysteresis keeps
    those shapes while utilization allows.  Builds handed no hints
    produce the deterministic natural buckets.

    Telemetry: the whole build is the ``epoch.build`` phase (per-hood
    neighbor searches under ``epoch.hood_build``); the resulting table
    shapes land as ``epoch.*`` gauges.
    """
    with metrics.phase("epoch.build"):
        epoch = _build_epoch_impl(
            mapping, topology, leaves, n_devices, neighborhoods,
            uniform_geometry=uniform_geometry, shape_hints=shape_hints,
        )
    record_epoch_gauges(epoch)
    return epoch


def record_epoch_gauges(epoch: Epoch) -> None:
    """The ``epoch.*`` table-shape gauges of a new epoch, and a sample of
    the device allocator (``obs.sample_hbm``; nothing without CUDA) —
    the moment memory margins change."""
    if not metrics.enabled:
        return
    metrics.gauge("epoch.n_cells", len(epoch.leaves))
    metrics.gauge("epoch.rows_per_device", epoch.R)
    metrics.gauge("epoch.bucket_R", epoch.R)
    for hid, h in epoch.hoods.items():
        metrics.gauge("epoch.bucket_K", h.nbr_rows.shape[2],
                      hood="default" if hid is None else str(hid))
    metrics.gauge("epoch.ghost_cells", int(epoch.n_ghost.sum()))
    metrics.gauge("epoch.hoods", len(epoch.hoods))
    # send/recv schedule size: cells exchanged per full halo update,
    # summed over hoods (each pair table is symmetric by construction)
    metrics.gauge("epoch.send_table_cells", sum(
        int(h.pair_counts.sum()) for h in epoch.hoods.values()
    ))
    from ..obs.hbm import sample_hbm

    sample_hbm(metrics)


def _build_epoch_impl(
    mapping: Mapping,
    topology: Topology,
    leaves: LeafSet,
    n_devices: int,
    neighborhoods: dict,
    *,
    uniform_geometry: bool,
    shape_hints: dict | None = None,
) -> Epoch:
    hints = shape_hints or {}

    N = len(leaves)
    D = n_devices
    owner = leaves.owner.astype(np.int64)

    # --- pass 1: neighbor lists + ghost requirements per hood
    hood_raw = {}
    all_pairs = []
    for hid, offsets in neighborhoods.items():
        with metrics.phase("epoch.hood_build"):
            lists, to_start, to_src, pairs, is_outer = _build_hood(
                mapping, topology, leaves, offsets, D
            )
        hood_raw[hid] = (offsets, lists, to_start, to_src, pairs, is_outer)
        all_pairs.append(pairs)
    if all_pairs:
        from ..utils.setops import unique_pairs

        cat = np.concatenate(all_pairs, axis=0)
        dev_u, pos_u = unique_pairs(cat[:, 0], cat[:, 1], max(N, 1))
        pairs = np.stack([dev_u, pos_u], axis=1)
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)

    # --- row layout
    epoch, len_all = _row_layout(mapping, topology, leaves, D, pairs,
                                 prev_R=hints.get("R"))

    # --- pass 2: per-hood device tables + schedules
    for hid, (offsets, lists, to_start, to_src, h_pairs, is_outer) in (
        hood_raw.items()
    ):
        epoch.hoods[hid] = _finish_hood(
            epoch, offsets, lists, to_start, to_src, h_pairs, len_all,
            is_outer, prev_K=hints.get("K", {}).get(hid),
        )
    epoch.dense = (
        detect_dense(mapping, topology, leaves, D)
        if uniform_geometry else None
    )
    return epoch


def _row_layout(
    mapping: Mapping,
    topology: Topology,
    leaves: LeafSet,
    n_devices: int,
    pairs: np.ndarray,
    prev_R: int | None = None,
) -> tuple[Epoch, np.ndarray]:
    """Row layout + per-row cell tables for a (leaves, ghost pairs)
    snapshot: the hood-independent part of an epoch, shared by the full
    build and the incremental delta path.  Returns ``(epoch, len_all)``
    with ``epoch.hoods`` still empty.

    ``R`` is rounded up the geometric bucket ladder (``shapes.py``) so
    small growth/shrink keeps the payload shape — extra rows are
    ordinary pad rows (the same invariants as the inter-device padding
    that always existed below the widest device's row count)."""
    N = len(leaves)
    D = n_devices
    owner = leaves.owner.astype(np.int64)

    local_pos = [np.flatnonzero(owner == d) for d in range(D)]
    ghost_pos = [np.sort(pairs[pairs[:, 0] == d, 1]) for d in range(D)]
    n_local = np.array([len(p) for p in local_pos], dtype=np.int64)
    n_ghost = np.array([len(p) for p in ghost_pos], dtype=np.int64)
    R = int((n_local + n_ghost).max()) + 1 if N else 1
    R = bucket_rows(R, prev_R)

    row_of = np.zeros(N, dtype=np.int64)
    for d in range(D):
        row_of[local_pos[d]] = np.arange(n_local[d])

    cell_len = np.zeros((D, R), dtype=np.int32)
    cell_level = np.full((D, R), -1, dtype=np.int8)
    cell_ids = np.zeros((D, R), dtype=np.uint64)
    local_mask = np.zeros((D, R), dtype=bool)
    lvl_all = mapping.get_refinement_level(leaves.cells)
    len_all = mapping.get_cell_length_in_indices(leaves.cells).astype(np.int64)
    for d in range(D):
        rows_l = np.arange(n_local[d])
        rows_g = n_local[d] + np.arange(n_ghost[d])
        for rows, pos in ((rows_l, local_pos[d]), (rows_g, ghost_pos[d])):
            cell_len[d, rows] = len_all[pos]
            cell_level[d, rows] = lvl_all[pos]
            cell_ids[d, rows] = leaves.cells[pos]
        local_mask[d, rows_l] = True

    epoch = Epoch(
        mapping=mapping,
        topology=topology,
        leaves=leaves,
        n_devices=D,
        R=R,
        n_local=n_local,
        n_ghost=n_ghost,
        local_pos=local_pos,
        ghost_pos=ghost_pos,
        row_of=row_of,
        cell_len=cell_len,
        cell_level=cell_level,
        cell_ids=cell_ids,
        local_mask=local_mask,
    )
    return epoch, len_all


def _hood_schedule(epoch: Epoch, pairs: np.ndarray):
    """Pairwise-aligned send/recv row schedule for a hood's ghost pairs
    (reference's sorted send/recv lists, ``dccrg.hpp:8590-8752``)."""
    D, N = epoch.n_devices, len(epoch.leaves)
    scratch = epoch.R - 1
    owner = epoch.leaves.owner.astype(np.int64)
    recv_d = pairs[:, 0]
    gpos = pairs[:, 1]
    send_d = owner[gpos]
    pair_counts = np.zeros((D, D), dtype=np.int64)
    if len(pairs):
        np.add.at(pair_counts, (send_d, recv_d), 1)
    S = int(pair_counts.max()) if pair_counts.size else 0
    S = max(S, 1)
    send_rows = np.full((D, D, S), scratch, dtype=np.int32)
    recv_rows = np.full((D, D, S), scratch, dtype=np.int32)
    if len(pairs):
        # group by (sender, receiver), position-sorted within each group
        gkey = (send_d * D + recv_d) * np.int64(max(N, 1)) + gpos
        order = np.argsort(gkey, kind="stable")
        sd, rd, gp = send_d[order], recv_d[order], gpos[order]
        grp_start = np.flatnonzero(
            np.concatenate(([True], (sd[1:] != sd[:-1]) | (rd[1:] != rd[:-1])))
        )
        in_grp = np.arange(len(gp)) - np.repeat(grp_start, np.diff(
            np.concatenate((grp_start, [len(gp)]))
        ))
        send_rows[sd, rd, in_grp] = epoch.row_of[gp]
        # receive rows: per receiving device, ghost index lookup
        rrow = np.empty(len(gp), dtype=np.int64)
        for d in range(D):
            m = rd == d
            if m.any():
                rrow[m] = epoch.rows_on_device(d, gp[m])
        recv_rows[rd, sd, in_grp] = rrow
    return send_rows, recv_rows, pair_counts


def _hood_masks(epoch: Epoch, is_outer: np.ndarray):
    """Inner/outer iteration masks (dccrg.hpp:7478-7519): outer = local
    cell with a remote cell among neighbors_of or neighbors_to."""
    D, R = epoch.n_devices, epoch.R
    inner_mask = np.zeros((D, R), dtype=bool)
    outer_mask = np.zeros((D, R), dtype=bool)
    for d in range(D):
        lp = epoch.local_pos[d]
        rows = np.arange(len(lp))
        inner_mask[d, rows] = ~is_outer[lp]
        outer_mask[d, rows] = is_outer[lp]
    return inner_mask, outer_mask


def _finish_hood(
    epoch: Epoch,
    offsets: np.ndarray,
    lists: NeighborLists,
    to_start: np.ndarray,
    to_src: np.ndarray,
    pairs: np.ndarray,
    len_all: np.ndarray,
    is_outer: np.ndarray,
    prev_K: int | None = None,
) -> HoodState:
    D, R, N = epoch.n_devices, epoch.R, len(epoch.leaves)
    owner = epoch.leaves.owner.astype(np.int64)
    scratch = R - 1

    send_rows, recv_rows, pair_counts = _hood_schedule(epoch, pairs)

    # --- neighbor gather tables over local rows; Kmax rides the fixed
    # bucket ladder (pad slots: scratch row, nbr_valid False — exactly
    # the existing short-row padding)
    counts = np.diff(lists.start)
    Kmax = int(counts.max()) if N else 1
    Kmax = bucket_k(max(Kmax, 1), prev_K)
    nbr_rows = np.full((D, R, Kmax), scratch, dtype=np.int32)
    nbr_valid = np.zeros((D, R, Kmax), dtype=bool)
    nbr_offset = np.zeros((D, R, Kmax, 3), dtype=np.int32)
    nbr_len = np.zeros((D, R, Kmax), dtype=np.int32)
    nbr_slot = np.zeros((D, R, Kmax), dtype=np.int32)
    E = int(lists.start[-1])
    if E:
        from ..native import native_fill_tables

        filled = native_fill_tables(
            lists.start, lists.nbr_pos, lists.offset, lists.slot,
            owner, epoch.row_of, len_all, epoch.ghost_pos, epoch.n_local,
            D, R, Kmax,
            nbr_rows, nbr_valid, nbr_offset, nbr_len, nbr_slot,
        )
        if not filled:
            # numpy fallback: flat one-pass scatters over the edge arrays
            from ..utils.setops import ragged_arange

            esrc = np.repeat(np.arange(N), counts)
            ecol = ragged_arange(counts)
            # one N-sized precompute replaces two E-sized gathers
            grow = owner * np.int64(R) + epoch.row_of.astype(np.int64)
            flat = grow[esrc] * np.int64(Kmax) + ecol
            if flat.size and D * R * Kmax < np.iinfo(np.int32).max:
                flat = flat.astype(np.int32)  # halves scatter index traffic
            # row of each neighbor on the source's device
            edev = owner[esrc]
            nrows = np.empty(E, dtype=np.int64)
            local_e = owner[lists.nbr_pos] == edev
            nrows[local_e] = epoch.row_of[lists.nbr_pos[local_e]]
            rem = np.flatnonzero(~local_e)
            for d in range(D):
                sub = rem[edev[rem] == d]
                if len(sub):
                    nrows[sub] = epoch.rows_on_device(d, lists.nbr_pos[sub])
            nbr_rows.reshape(-1)[flat] = nrows
            nbr_valid.reshape(-1)[flat] = True
            nbr_offset.reshape(-1, 3)[flat] = lists.offset
            nbr_len.reshape(-1)[flat] = len_all[lists.nbr_pos]
            nbr_slot.reshape(-1)[flat] = lists.slot
    # inner/outer split computed alongside the ghost pairs in _build_hood
    inner_mask, outer_mask = _hood_masks(epoch, is_outer)

    return HoodState(
        offsets=offsets,
        lists=lists,
        to_start=to_start,
        to_src=to_src,
        send_rows=send_rows,
        recv_rows=recv_rows,
        pair_counts=pair_counts,
        inner_mask=inner_mask,
        outer_mask=outer_mask,
        nbr_rows=nbr_rows,
        nbr_valid=nbr_valid,
        nbr_offset=nbr_offset,
        nbr_len=nbr_len,
        nbr_slot=nbr_slot,
    )
