"""Static-offset decomposition of the general stencil matvec.

The gather-path operator

    (A·x)[r] = scaling[r]·x[r] + Σ_k mult[r, k] · x[nbr_rows[r, k]]

has static structure: ``nbr_rows`` and ``mult`` are epoch constants (the
reference's cached neighbor pointer lists and per-pair factors,
``poisson_solve.hpp:716-965``).  Grouping the nonzero entries by their row
offset ``d = nbr_rows[r, k] - r`` collapses all entries sharing an offset
into one dense term ``W_d[r] · roll(x, -d)``; rare offsets fall into a
small exception list ``y[exc_r] += exc_w · x[exc_idx]``.  When the offset
histogram is too flat for that to pay (``None``), callers keep the gather.

The host builders are copies of the JAX package's
(``dccrg_tpu/ops/rolled_gather.py``), so both packages decompose alike; the
appliers are torch: one ``torch.roll`` along the row axis per dense term, in
ascending offset order, then the exception term as one ``index_add_``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_rolled_matvec", "make_rolled_apply",
           "build_rolled_matvec_multi", "make_rolled_apply_multi"]

#: build_rolled_matvec defaults (the JAX package's): a head of <= 64
#: offsets plus a <= 15% exception tail
MAX_TERMS = 64
MIN_COUNT_FRAC = 0.004
MAX_EXC_FRAC = 0.15


def build_rolled_matvec(nbr_rows, mult, scaling, *, max_terms=MAX_TERMS,
                        min_count_frac=MIN_COUNT_FRAC,
                        max_exc_frac=MAX_EXC_FRAC):
    """Static tables for the rolled matvec, or None when the offset
    histogram is too flat to beat the gather.

    ``nbr_rows``: (R, K) int — neighbor row per (row, slot), any value
    for entries whose ``mult`` is zero (they are dropped).
    ``mult``: (R, K) float — per-entry multipliers, zeros for missing /
    inactive entries.  ``scaling``: (R,) float — the diagonal.

    Returns ``{"offsets", "weights" (T, R), "exc_r", "exc_idx",
    "exc_w", "scaling"}`` (all numpy; ``make_rolled_apply`` moves them
    to the device).
    """
    nbr_rows = np.asarray(nbr_rows)
    mult = np.asarray(mult)
    scaling = np.asarray(scaling)
    R, K = nbr_rows.shape
    if R == 0:
        return None

    rr, kk = np.nonzero(mult)
    if rr.size == 0:
        return {  # pure-diagonal system: zero dense terms, no exceptions
            "offsets": [], "weights": np.zeros((0, R), mult.dtype),
            "exc_r": np.zeros(0, np.int32), "exc_idx": np.zeros(0, np.int32),
            "exc_w": np.zeros(0, mult.dtype), "scaling": scaling,
        }
    idx = nbr_rows[rr, kk].astype(np.int64)
    ww = mult[rr, kk]
    d = idx - rr

    offs, inv, counts = np.unique(d, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(counts)[::-1]
    min_count = max(1, int(min_count_frac * R))
    dense_o = [o for o in order[:max_terms] if counts[o] >= min_count]
    dense_set = np.zeros(len(offs), dtype=bool)
    dense_set[dense_o] = True

    is_dense = dense_set[inv]
    n_exc = int((~is_dense).sum())
    if n_exc > max_exc_frac * rr.size:
        return None

    # rank dense terms by offset value: deterministic order -> the
    # roll chain (and therefore fp association) is stable across builds
    # of the same structure
    dense_sorted = sorted(dense_o, key=lambda o: int(offs[o]))
    T = len(dense_sorted)
    weights = np.zeros((T, R), dtype=mult.dtype)
    t_of = np.full(len(offs), -1)
    t_of[dense_sorted] = np.arange(T)
    t_of_entry = t_of[inv]
    m = is_dense
    np.add.at(weights, (t_of_entry[m], rr[m]), ww[m])

    e = ~is_dense
    # sort exceptions by source index: the residual gather walks x
    # monotonically (and the scatter-add association becomes a stable
    # function of the structure, not of np.nonzero's entry order)
    eo = np.lexsort((rr[e], idx[e]))
    return {
        "offsets": [int(offs[o]) for o in dense_sorted],
        "weights": weights,
        "exc_r": rr[e][eo].astype(np.int32),
        "exc_idx": idx[e][eo].astype(np.int32),
        "exc_w": ww[e][eo],
        "scaling": scaling,
    }


def build_rolled_matvec_multi(nbr_rows, mult, scaling, *,
                              max_terms=MAX_TERMS,
                              min_count_frac=MIN_COUNT_FRAC,
                              max_exc_frac=MAX_EXC_FRAC):
    """Per-slot decompositions with a UNION offset set, or None when any
    slot's histogram refuses.

    ``nbr_rows``/``mult``: (D, R, K); ``scaling``: (D, R).  Each slot's row
    block is its own roll space (local + ghost + scratch rows, ghost values
    refreshed by the halo exchange before the apply, as on the gather
    path).  The union of the per-slot offset heads becomes the term list
    and a slot missing an offset carries zero weights for it.  Exception
    lists are right-padded per slot with zero-weight entries pointing at
    row 0.

    Returns ``{"offsets", "weights" (D, T, R), "exc_r"/"exc_idx"
    (D, E), "exc_w" (D, E), "scaling" (D, R)}``.
    """
    nbr_rows = np.asarray(nbr_rows)
    mult = np.asarray(mult)
    scaling = np.asarray(scaling)
    D, R, K = nbr_rows.shape
    per_dev = []
    for d in range(D):
        t = build_rolled_matvec(
            nbr_rows[d], mult[d], scaling[d], max_terms=max_terms,
            min_count_frac=min_count_frac, max_exc_frac=max_exc_frac)
        if t is None:
            return None
        per_dev.append(t)

    union = sorted({o for t in per_dev for o in t["offsets"]})
    if len(union) > 2 * max_terms:  # union blow-up across slots
        return None
    slot = {o: i for i, o in enumerate(union)}
    T = len(union)
    weights = np.zeros((D, T, R), dtype=mult.dtype)
    for d, t in enumerate(per_dev):
        for i, o in enumerate(t["offsets"]):
            weights[d, slot[o]] = t["weights"][i]

    E = max((t["exc_r"].size for t in per_dev), default=0)
    exc_r = np.zeros((D, E), np.int32)
    exc_idx = np.zeros((D, E), np.int32)
    exc_w = np.zeros((D, E), dtype=mult.dtype)
    for d, t in enumerate(per_dev):
        n = t["exc_r"].size
        exc_r[d, :n] = t["exc_r"]
        exc_idx[d, :n] = t["exc_idx"]
        exc_w[d, :n] = t["exc_w"]

    return {"offsets": union, "weights": weights, "exc_r": exc_r,
            "exc_idx": exc_idx, "exc_w": exc_w, "scaling": scaling}


def make_rolled_apply_multi(tables, dtype, device, slots=None):
    """``apply(x: [D, R]) -> [D, R]`` from :func:`build_rolled_matvec_multi`
    tables, on ``device``: per-slot rolls along the row axis (offsets
    ascending), then the exceptions by ``index_add_`` over the flattened
    rows.  Ghost rows are the caller's to refresh first.

    The exceptions go in rounds, the k-th exception of every row in round k,
    so no round adds twice to one row: the sum is the entry order's (that of
    one sequential ``index_add_``), and a CUDA ``index_add_``'s atomics
    cannot reorder it.  The zero-weight entries that pad the slots' lists
    add nothing and are left out.  ``slots``: this controller's block of the D slots
    (a ``range``, default all): ``x`` is then ``[len(slots), R]``."""
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
    D = np.asarray(tables["scaling"]).shape[0]
    sl = slice(0, D) if slots is None else slice(slots.start, slots.stop)
    offsets = list(tables["offsets"])
    weights = put(np.asarray(tables["weights"])[sl], dtype)   # [D, T, R]
    scaling = put(np.asarray(tables["scaling"])[sl], dtype)   # [D, R]
    D, R = scaling.shape
    base = np.arange(D, dtype=np.int64)[:, None] * R
    src = (base + np.asarray(tables["exc_idx"])[sl]).reshape(-1)
    dst = (base + np.asarray(tables["exc_r"])[sl]).reshape(-1)
    w = np.asarray(tables["exc_w"])[sl].reshape(-1)
    # the per-slot right-padding (zero weights at row 0) adds only zeros:
    # dropped, it would otherwise make a round of every pad entry
    real = w != 0
    src, dst, w = src[real], dst[real], w[real]
    # each entry's rank among the earlier entries of its row
    order = np.argsort(dst, kind="stable")
    ds = dst[order]
    first = np.r_[0, np.flatnonzero(np.diff(ds)) + 1] if len(ds) else np.zeros(0, np.int64)
    rank = np.empty(len(dst), np.int64)
    rank[order] = np.arange(len(ds)) - np.repeat(first, np.diff(np.r_[first, len(ds)]))
    rounds = [(put(dst[rank == k], torch.int64), put(src[rank == k], torch.int64),
               put(w[rank == k], dtype))
              for k in range(int(rank.max()) + 1 if len(rank) else 0)]

    def apply(x):
        y = scaling * x
        for t, o in enumerate(offsets):
            y = y + weights[:, t] * torch.roll(x, -o, 1)
        if rounds:
            xf, y = x.reshape(-1), y.reshape(-1)
            for exc_dst, exc_src, exc_w in rounds:
                y = y.index_add_(0, exc_dst, exc_w * xf[exc_src])
            y = y.reshape(D, R)
        return y

    return apply


def make_rolled_apply(tables, dtype, device):
    """``apply(x: [R]) -> [R]`` from :func:`build_rolled_matvec` tables:
    the one-slot case of :func:`make_rolled_apply_multi`."""
    one = {k: (v if k == "offsets" else np.asarray(v)[None])
           for k, v in tables.items()}
    apply = make_rolled_apply_multi(one, dtype, device)
    return lambda x: apply(x[None])[0]
