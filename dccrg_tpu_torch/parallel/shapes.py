"""Shape-stable epochs: bucketed table dimensions + shape signatures.

Every structural change (AMR commit, repartition) used to produce fresh
``[D, R, Kmax]`` table shapes, so each jitted schedule — halo bodies,
model step/run kernels, fused dispatch wrappers — retraced and
recompiled from scratch after every rebuild.  PR 3 removed the host-side
rebuild cost; the device-side compile storm is what remained.

This module makes the shapes sticky, the same discipline a serving stack
uses to keep batch-size churn from thrashing the XLA cache:

* **rows** (``R``, including the scratch row) round UP a geometric
  ladder (``DCCRG_EPOCH_BUCKET_GROWTH``, default 1.25x per step);
* **neighbor slots** (``Kmax``) round UP a small fixed ladder
  (``DCCRG_EPOCH_KMAX_LADDER``), doubling past its last entry;
* **ring step sizes** (the per-distance halo pair counts) ride the same
  geometric ladder.

Padding stays inside the existing invariants — pad rows carry
``cell_len = 0`` / ``cell_level = -1`` / ``cell_ids = 0`` /
``local_mask = False``, pad gather slots point at the scratch row with
``nbr_valid = False``, pad schedule slots ship the scratch row — so
bucketed results are **bit-identical** to an unbucketed run
(``DCCRG_EPOCH_BUCKETS=0`` forces exact shapes for comparison).

Hysteresis: with a ``prev`` shape supplied (the pre-change epoch's), a
bucket only SHRINKS when utilization drops below
``DCCRG_EPOCH_BUCKET_SHRINK`` (default 0.5) of the held value — a grid
oscillating around a ladder boundary never flaps between shapes.  The
choice is idempotent: re-bucketing ``n`` against the chosen value
returns the chosen value, so a verification rebuild handed the live
epoch's shapes as hints reproduces it exactly.
"""
from __future__ import annotations

import math
import os
import zlib
from typing import NamedTuple

__all__ = [
    "ShapeSignature",
    "ring_signature",
    "signature_of",
    "epoch_shape_hints",
    "buckets_enabled",
    "bucket_rows",
    "bucket_k",
    "bucket_pairs",
]

#: default ``Kmax`` ladder: fixed small steps (vertex hoods sit at 26,
#: 2:1 AMR faces push past it), doubling beyond the last entry
_K_LADDER = (1, 2, 4, 6, 8, 12, 16, 20, 26, 32, 40, 48, 64, 80, 96, 128)


def buckets_enabled() -> bool:
    return os.environ.get("DCCRG_EPOCH_BUCKETS", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, default))
    except ValueError:
        return default
    return v if math.isfinite(v) and v > 0 else default


def _growth() -> float:
    g = _env_float("DCCRG_EPOCH_BUCKET_GROWTH", 1.25)
    return g if g > 1.0 else 1.25


def _shrink() -> float:
    s = _env_float("DCCRG_EPOCH_BUCKET_SHRINK", 0.5)
    return min(s, 1.0)


def _k_ladder() -> tuple:
    raw = os.environ.get("DCCRG_EPOCH_KMAX_LADDER", "")
    if not raw:
        return _K_LADDER
    try:
        vals = tuple(sorted({int(v) for v in raw.split(",") if v.strip()}))
    except ValueError:
        return _K_LADDER
    return vals if vals and vals[0] >= 1 else _K_LADDER


def _hysteresis(natural: int, n: int, prev) -> int:
    """Keep ``prev`` while utilization stays above the shrink floor; the
    result re-buckets to itself (idempotence — see module docstring)."""
    if prev is None or prev < natural:
        return natural
    if natural == prev or n >= _shrink() * prev:
        return prev
    return natural


def bucket_rows(n: int, prev: int | None = None) -> int:
    """Row budget ``n`` rounded up the geometric ladder (with hysteresis
    against ``prev``); exact when bucketing is disabled."""
    n = max(int(n), 1)
    if not buckets_enabled():
        return n
    g = _growth()
    v = 8
    while v < n:
        v = max(v + 1, int(math.ceil(v * g)))
    return _hysteresis(v, n, prev)


def bucket_k(n: int, prev: int | None = None) -> int:
    """Neighbor-slot budget ``n`` rounded up the fixed ``Kmax`` ladder
    (doubling past its end), with hysteresis against ``prev``."""
    n = max(int(n), 1)
    if not buckets_enabled():
        return n
    for v in _k_ladder():
        if v >= n:
            return _hysteresis(v, n, prev)
    v = _k_ladder()[-1]
    while v < n:
        v *= 2
    return _hysteresis(v, n, prev)


#: ring-step pair counts ride the same geometric ladder as rows
bucket_pairs = bucket_rows


def _hood_key(hid) -> int:
    # hood ids are ints or None (the default hood); None sorts as -1 so
    # signatures are plain sortable tuples
    return -1 if hid is None else int(hid)


class ShapeSignature(NamedTuple):
    """The compiled-schedule identity of an epoch: every dimension a
    jitted kernel's trace depends on.  Two epochs with equal signatures
    share every compiled executable — only table *contents* differ, and
    those flow through kernels as runtime arguments.

    ``rings`` surfaces the held halo ring-size hints (the per-distance
    bucketed pair counts ``parallel/halo.py`` keeps grid-persistent): the
    payload/table shapes of every exchange body and fused split-phase
    kernel ride them, so without this field two grids could share
    ``(n_devices, R, kmax, dense)`` yet compile different programs.  With
    it, ``grid.shape_signature()`` alone predicts executable-cache
    behavior — equal signatures (same mesh) mean a rescaled or restarted
    worker re-dispatches or cache-hits every compiled executable."""

    n_devices: int
    R: int
    kmax: tuple           # sorted ((hood_key, Kmax), ...)
    dense: bool           # dense fast path detected
    rings: tuple = ()     # sorted ((hood_key, field, k, S_k), ...)

    def label(self) -> str:
        """Short deterministic telemetry label for this signature —
        stable ACROSS PROCESSES AND ROUNDS (unlike ``hash()``, which is
        salted per interpreter), so labeled series such as
        ``ensemble.cohort_occupancy{signature=...}`` line up between a
        bench round and its baseline.  Leading fields stay readable
        (device count, rows, dense flag); the kmax/ring structure is
        folded into a CRC so the label stays one short token."""
        crc = zlib.crc32(repr((self.kmax, self.rings)).encode())
        return (f"d{self.n_devices}.R{self.R}."
                f"{'dense' if self.dense else 'gather'}.{crc:08x}")


def ring_signature(ring_hints) -> tuple:
    """Canonical sortable form of the grid-persistent ring-size hints
    (``{(hood_id, field, k): held S_k}``) for :class:`ShapeSignature`.
    Empty before the first halo schedule is built."""
    if not ring_hints:
        return ()
    return tuple(sorted(
        (_hood_key(hid), "" if field is None else str(field),
         int(k), int(v))
        for (hid, field, k), v in ring_hints.items()
    ))


def signature_of(epoch, ring_hints=None) -> ShapeSignature:
    return ShapeSignature(
        n_devices=int(epoch.n_devices),
        R=int(epoch.R),
        kmax=tuple(sorted(
            (_hood_key(hid), int(h.nbr_rows.shape[2]))
            for hid, h in epoch.hoods.items()
        )),
        dense=epoch.dense is not None,
        rings=ring_signature(ring_hints),
    )


def epoch_shape_hints(epoch) -> dict:
    """Hysteresis hints for the next (re)build, taken from a live epoch:
    ``{"R": rows, "K": {hood_id: Kmax}}``.  Handing a build the epoch's
    own shapes reproduces the epoch (bucket idempotence), which is what
    the verification oracle relies on."""
    if epoch is None:
        return {}
    return {
        "R": int(epoch.R),
        "K": {hid: int(h.nbr_rows.shape[2])
              for hid, h in epoch.hoods.items()},
    }
