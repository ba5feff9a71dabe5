"""Device-side stencil support: neighbor gather tables as device tensors.

The reference's iteration facade hands user code cached per-cell neighbor
pointer lists (``Cells_Item``/``Neighbors_Item``, ``dccrg.hpp:7279-7602``).
Here, as in the JAX package's ``parallel/stencil.py``, they are dense
``[D, R, K]`` gather tables — row indices, validity masks, offsets, sizes —
placed on the grid's device once per (epoch, neighborhood), so a workload
step is a handful of tensor ops with no host involvement.
"""
from __future__ import annotations

import numpy as np
import torch

from .shapes import bucket_rows

__all__ = ["StencilTables", "gather_neighbors", "ordered_sum", "compact_rows",
           "split_rows"]


def compact_rows(mask: np.ndarray, scratch: int,
                 width: int | None = None) -> np.ndarray:
    """Per-device padded row lists from a ``[D, R]`` bool mask: returns
    ``[D, W]`` int32 with each device's True rows first and the scratch row
    as padding.  ``width`` pads W up to a caller-chosen value."""
    D, R = mask.shape
    counts = mask.sum(axis=1)
    W = max(int(counts.max()) if D else 0, 1)
    if width is not None:
        if width < W:
            raise ValueError(f"width {width} below natural {W}")
        W = width
    rows = np.full((D, W), scratch, dtype=np.int32)
    for d in range(D):
        rows[d, : counts[d]] = np.flatnonzero(mask[d])
    return rows


def split_rows(grid, hood_id):
    """The inner and outer row sets of a split-phase step: each ``[D, W]``
    from :func:`compact_rows`, W on the bucket ladder with the grid's hints
    ``(hood_id, "split.inner"/"split.outer", 0)``, pad lanes the scratch
    row.  Inner rows have no remote neighbor; outer rows do."""
    epoch = grid.epoch
    hood = epoch.hoods[hood_id]
    hints = grid._ring_hints
    out = []
    for side, mask in (("inner", hood.inner_mask), ("outer", hood.outer_mask)):
        key = (hood_id, f"split.{side}", 0)
        W = bucket_rows(max(int(mask.sum(axis=1).max()), 1), hints.get(key))
        hints[key] = W
        out.append(compact_rows(mask, epoch.R - 1, width=W))
    return out[0], out[1]


class StencilTables:
    """Device tensors describing one neighborhood's structure.

    Attributes (all on the grid's device, leading axis the device slot;
    under several controllers this controller's slots, ``grid.slots``):
      nbr_rows   [D, R, K] int64 — row of each neighbor entry (scratch-padded)
      nbr_valid  [D, R, K] bool  — entry exists
      nbr_offset [D, R, K, 3] int32 — neighbor min corner - cell min corner
                 in index units (reference ``Neighbors_Item.x/y/z``)
      nbr_len    [D, R, K] int32 — neighbor edge length in index units
      nbr_slot   [D, R, K] int32 — originating neighborhood-offset index
      cell_len   [D, R] int32 — cell edge length in index units
      cell_level [D, R] int8
      local_mask / inner_mask / outer_mask  [D, R] bool
    and, ``with_geometry``, ``center`` / ``length`` ``[D, R, 3]`` float64
    (ghost rows included; pad rows hold center 0 and length 1).
    """

    def __init__(self, grid, hood_id=None, with_geometry: bool = False,
                 cell_items: dict | None = None,
                 neighbor_items: dict | None = None):
        """``cell_items`` / ``neighbor_items``: the reference's
        Additional_Cell_Items / Additional_Neighbor_Items mixins
        (``dccrg.hpp:7288-7402``), named callbacks evaluated when the
        tables are built and placed on the device as extra attributes.

        * ``cell_items[name] = fn(grid, cell_ids) -> (N, ...)`` becomes a
          ``[D, R, ...]`` attribute (local and ghost rows);
        * ``neighbor_items[name] = fn(grid, cell_ids, nbr_ids, offsets) ->
          (E, ...)`` becomes a ``[D, R, K, ...]`` attribute.
        """
        epoch = grid.epoch
        hood = epoch.hoods[hood_id]
        # always a copy: on the CPU as_tensor would share the epoch's arrays,
        # whose hood tables the grid recycles after a structural change;
        # under several controllers only this controller's slots
        put = lambda a, dt=None: torch.tensor(np.asarray(grid.slot_view(a)),
                                              dtype=dt, device=grid.device)
        # gather indices as int64, the index type torch's advanced indexing
        # takes without a conversion per step
        self.nbr_rows = put(hood.nbr_rows, torch.int64)
        self.nbr_valid = put(hood.nbr_valid)
        self.nbr_offset = put(hood.nbr_offset)
        self.nbr_len = put(hood.nbr_len)
        self.nbr_slot = put(hood.nbr_slot)
        self.cell_len = put(epoch.cell_len)
        self.cell_level = put(epoch.cell_level)
        self.local_mask = put(epoch.local_mask)
        self.inner_mask = put(hood.inner_mask)
        self.outer_mask = put(hood.outer_mask)
        if with_geometry:
            ids = epoch.cell_ids
            centers = grid.geometry.get_center(ids)
            lengths = grid.geometry.get_length(ids)
            pad = ~epoch.local_mask & (epoch.cell_len == 0)
            centers[pad] = 0.0
            lengths[pad] = 1.0
            self.center = put(centers)
            self.length = put(lengths)
            #: ``length`` on the host for every slot ``[D, R, 3]`` (face
            #: factors read neighbours' rows on any slot)
            self.length_host = lengths

        leaves = epoch.leaves
        for name, fn in (cell_items or {}).items():
            vals = np.asarray(fn(grid, leaves.cells))
            out = np.zeros((epoch.n_devices, epoch.R) + vals.shape[1:], vals.dtype)
            for d in range(epoch.n_devices):
                lp, gp = epoch.local_pos[d], epoch.ghost_pos[d]
                out[d, : len(lp)] = vals[lp]
                out[d, len(lp) : len(lp) + len(gp)] = vals[gp]
            setattr(self, name, put(out))

        if neighbor_items:
            lists = hood.lists
            counts = np.diff(lists.start)
            src = np.repeat(np.arange(len(leaves)), counts)
            E = int(lists.start[-1])
            ecol = np.arange(E, dtype=np.int64) - np.repeat(lists.start[:-1], counts)
            owner = leaves.owner.astype(np.int64)
            D, R, K = hood.nbr_rows.shape
            for name, fn in neighbor_items.items():
                vals = np.asarray(
                    fn(grid, leaves.cells[src], lists.nbr_cell, lists.offset)
                )
                out = np.zeros((D, R, K) + vals.shape[1:], vals.dtype)
                for d in range(D):
                    sel = owner[src] == d
                    out[d, epoch.row_of[src[sel]], ecol[sel]] = vals[sel]
                setattr(self, name, put(out))


def gather_neighbors(x, nbr_rows, members: bool = False):
    """Gather neighbor rows: x ``[D, R, ...]`` + nbr_rows ``[D, R, K]`` ->
    ``[D, R, K, ...]``.  With ``members``, x is a member stack ``[W, D, R,
    ...]`` and nbr_rows ``[M, D, R, K]`` with M = 1 (one table every member
    shares, broadcast, never copied) or W: ``[W, D, R, K, ...]``."""
    if members:
        return x[(*member_index(x, nbr_rows.dim()), nbr_rows)]
    D = x.shape[0]
    dev = torch.arange(D, device=x.device).view(D, 1, 1)
    return x[dev, nbr_rows]


#: member_index's tensors by (W, D, ndim, device): made once
_MEMBER_INDEX: dict = {}


def member_index(x, ndim: int):
    """The (member, slot) index tensors that broadcast against an
    ``ndim``-dimensional ``[M, D, ...]`` row table over the stack ``x [W,
    D, R, ...]`` (cached: a cohort step asks for the same ones every
    time)."""
    W, D = x.shape[:2]
    key = (W, D, ndim, str(x.device))
    idx = _MEMBER_INDEX.get(key)
    if idx is None:
        if len(_MEMBER_INDEX) > 256:
            _MEMBER_INDEX.clear()
        tail = (1,) * (ndim - 2)
        idx = _MEMBER_INDEX[key] = (
            torch.arange(W, device=x.device).view(W, 1, *tail),
            torch.arange(D, device=x.device).view(1, D, *tail))
    return idx


def member_rows(x, rows):
    """``x [W, D, R, ...]`` at the rows ``rows [M, D, n]`` of each member's
    slots: ``[W, D, n, ...]`` (the member form of ``x[ar, rows]``)."""
    return x[(*member_index(x, rows.dim()), rows)]


def ordered_sum(x, axis: int = -1):
    """Sum with a strict left-to-right association chain over ``axis``, so
    the same per-cell contributions give the same bits whatever the array
    shape or device count (``torch.sum`` picks its own reduction tree)."""
    parts = x.unbind(axis)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total
