"""Wide-halo planning: one depth-g exchange amortized over g interior steps.

A numpy copy of the JAX package's ``parallel/wide_halo.py``.  The dccrg
paper's cost model is that neighbor-data exchange, not compute, bounds
scaling, and its configurable neighborhood length exists so a deeper ghost
zone can amortize more local work per sync.  A cohort body
(``serve/ensemble.py``) exchanges the grid's full default-hood ghost zone
ONCE per block of interior steps, and each of them consumes one
stencil-radius shell of it, recomputing the shrinking ghost fringe
redundantly instead of re-exchanging.

The plan extends the per-epoch neighbor gather tables from owner-local rows
to EVERY row of every slot, ghost rows included, by replaying the owner
table scatter once per slot with ``Epoch.rows_on_device`` as the row
source.  Pad entries keep the owner-table convention (scratch row,
``nbr_valid`` False) and entries keep the owner's slot order, so a replica
row whose neighbors are all present computes the owner's update bit for
bit (same ``K``, same ``ordered_sum`` chain).

``steps_ok[d, r]`` is the staleness ledger: how many consecutive interior
steps row r on slot d stays correct after one exchange.  Rows missing a
stencil-relevant neighbor can never be stepped (0); everyone else is
``1 + min`` over its relevant neighbors, the greatest fixpoint of the
shell-consumption recurrence (a fully-local ring of rows saturates at
``_CAP``).  An interior step j updates exactly the rows with ``steps_ok >
j``.  The budget is the min over LOCAL rows.

Stencil relevance:

* ``"face"`` — only face-coupled entries count (the advection and Vlasov
  flux steps price nothing else).  As the port's face tables do, each
  (neighbor, direction) is priced once (``core.neighbors.first_faces``):
  at neighborhood length >= 1 a larger face neighbor listed for several
  offsets is one face, not several.  Relevance marks which neighbors a
  row needs, so the repeated entries never change ``steps_ok``.
* ``"all"`` — every list entry counts (the life rule reads the whole
  neighborhood); Game of Life amortizes on a radius-1 sub-neighborhood of
  a deeper default hood.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.neighbors import face_directions, first_faces
from ..utils.setops import ragged_arange

__all__ = [
    "WidePlan",
    "build_wide_plan",
    "get_wide_plan",
    "scatter_rows",
    "wide_enabled",
    "halo_depth_cap",
]

#: saturation value for ``steps_ok`` — rows with no partition boundary in
#: sight are valid "forever" (any realistic dispatch depth)
_CAP = 255


def wide_enabled() -> bool:
    """Whether cohort bodies may hoist the exchange above the interior
    loop (``DCCRG_ENSEMBLE_WIDE``, default on).  Off forces the
    exchange-every-step bodies everywhere."""
    return os.environ.get("DCCRG_ENSEMBLE_WIDE", "1").lower() not in (
        "0", "false", "off",
    )


def halo_depth_cap() -> int:
    """Operator ceiling on the exchange-amortization depth actually spent
    per dispatch (``DCCRG_HALO_DEPTH``, default 64): bounds the redundant
    fringe recompute and the staleness window regardless of how deep the
    grid's ghost zone is."""
    try:
        cap = int(os.environ.get("DCCRG_HALO_DEPTH", 64))
    except ValueError:
        return 64
    return max(cap, 1)


@dataclass(frozen=True)
class WidePlan:
    """Device-extended gather tables + staleness ledger for one hood.

    All arrays host-side numpy; models put on the device what their steps
    consume.  ``nbr_*`` have the owner tables' exact shape ``[D, R, K]``
    (same bucketed ``Kmax``) but are filled for every present row on
    every device; owner-local rows are bitwise equal to the
    ``HoodState`` tables."""

    nbr_rows: np.ndarray     # (D, R, K) int32, scratch-padded
    nbr_valid: np.ndarray    # (D, R, K) bool
    nbr_offset: np.ndarray   # (D, R, K, 3) int32
    nbr_len: np.ndarray      # (D, R, K) int32
    nbr_slot: np.ndarray     # (D, R, K) int32
    steps_ok: np.ndarray     # (D, R) int32 — valid interior steps per row
    local_mask: np.ndarray   # (D, R) bool — owner rows (the correctness set)
    budget: int              # min steps_ok over local rows


def scatter_rows(epoch, values: np.ndarray) -> np.ndarray:
    """Per-leaf ``(N, ...)`` values scattered to ``(D, R, ...)`` on EVERY
    device holding the leaf — owner local row and each replica ghost row.
    The wide analogue of scattering through ``Epoch.global_rows`` (owner
    rows only): interior steps update ghost rows too, so per-row model
    tables (e.g. vlasov's open-boundary face areas) must be present on
    the replicas as well."""
    values = np.asarray(values)
    D, R = epoch.local_mask.shape
    out = np.zeros((D, R) + values.shape[1:], values.dtype)
    for d in range(D):
        lp, gp = epoch.local_pos[d], epoch.ghost_pos[d]
        out[d, : len(lp)] = values[lp]
        out[d, len(lp) : len(lp) + len(gp)] = values[gp]
    return out


def build_wide_plan(grid, hood_id=None, relevance: str = "face") -> WidePlan:
    """Build the wide-halo plan for one neighborhood (see module doc)."""
    if relevance not in ("face", "all"):
        raise ValueError(f"unknown stencil relevance {relevance!r}")
    epoch = grid.epoch
    hood = epoch.hoods[hood_id]
    D, R, Kmax = hood.nbr_rows.shape
    N = len(epoch.leaves)
    scratch = R - 1
    lists = hood.lists
    counts = np.diff(lists.start)
    E = int(lists.start[-1])

    # per-leaf edge length in index units, read back off the epoch tables
    owner = epoch.leaves.owner.astype(np.int64)
    len_all = epoch.cell_len[owner, epoch.row_of.astype(np.int64)]

    esrc = np.repeat(np.arange(N), counts)
    ecol = ragged_arange(counts)
    nlen_e = len_all[lists.nbr_pos]
    if relevance == "face":
        dir_e = face_directions(lists.offset, len_all[esrc], nlen_e)
        rel_e = dir_e != 0
        f = np.flatnonzero(rel_e)
        keep = first_faces(esrc[f], lists.nbr_pos[f].astype(np.int64) * 8
                           + dir_e[f].astype(np.int64) + 3)
        rel_e[f[~keep]] = False
    else:
        rel_e = np.ones(E, dtype=bool)

    nbr_rows = np.full((D, R, Kmax), scratch, dtype=np.int32)
    nbr_valid = np.zeros((D, R, Kmax), dtype=bool)
    nbr_offset = np.zeros((D, R, Kmax, 3), dtype=np.int32)
    nbr_len = np.zeros((D, R, Kmax), dtype=np.int32)
    nbr_slot = np.zeros((D, R, Kmax), dtype=np.int32)
    steps_ok = np.zeros((D, R), dtype=np.int32)

    all_pos = np.arange(N, dtype=np.int64)
    for d in range(D):
        rows_d = epoch.rows_on_device(d, all_pos)          # (N,)
        present = rows_d != scratch
        c_ok = np.zeros(R, dtype=np.int64)
        c_ok[rows_d[present]] = _CAP
        c_ok[scratch] = 0
        if E:
            nrow_e = epoch.rows_on_device(d, lists.nbr_pos)  # (E,)
            sel = np.flatnonzero(present[esrc])
            r, c = rows_d[esrc[sel]], ecol[sel]
            nv = nrow_e[sel] != scratch
            nbr_rows[d, r, c] = np.where(nv, nrow_e[sel], scratch)
            nbr_valid[d, r, c] = nv
            nbr_offset[d, r, c] = lists.offset[sel]
            nbr_len[d, r, c] = nlen_e[sel]
            nbr_slot[d, r, c] = lists.slot[sel]

            # staleness relaxation over the stencil-relevant edge set
            rsel = np.flatnonzero(present[esrc] & rel_e)
            er = rows_d[esrc[rsel]]
            en = nrow_e[rsel]
            good = np.zeros(R, dtype=bool)
            good[rows_d[present]] = True
            good[scratch] = False
            good[er[en == scratch]] = False   # missing relevant neighbor
            c_ok = np.where(good, _CAP, 0)
            if len(rsel):
                # monotone descent from above to the greatest fixpoint
                # c(p) = 1 + min over relevant neighbors c(q); all-good
                # cycles stay at _CAP (no partition boundary → no
                # staleness), fronts propagate inward from the 0 rows
                for _ in range(R + 1):
                    mn = np.full(R, _CAP, dtype=np.int64)
                    np.minimum.at(mn, er, c_ok[en])
                    new = np.where(good, np.minimum(_CAP, 1 + mn), 0)
                    if np.array_equal(new, c_ok):
                        break
                    c_ok = new
        steps_ok[d] = c_ok.astype(np.int32)

    lm = epoch.local_mask
    budget = int(steps_ok[lm].min()) if lm.any() else 1
    return WidePlan(
        nbr_rows=nbr_rows,
        nbr_valid=nbr_valid,
        nbr_offset=nbr_offset,
        nbr_len=nbr_len,
        nbr_slot=nbr_slot,
        steps_ok=steps_ok,
        local_mask=lm.copy(),
        budget=budget,
    )


def get_wide_plan(grid, hood_id=None, relevance: str = "face") -> WidePlan:
    """Per-grid cached :func:`build_wide_plan` (invalidated when the
    epoch is rebuilt — the plan is pure epoch-derived metadata)."""
    cache = getattr(grid, "_wide_plans", None)
    if cache is None:
        cache = grid._wide_plans = {}
    key = (hood_id, relevance)
    hit = cache.get(key)
    if hit is not None and hit[0] is grid.epoch:
        return hit[1]
    plan = build_wide_plan(grid, hood_id, relevance)
    cache[key] = (grid.epoch, plan)
    return plan
