"""Native (C++) host-side kernels with transparent numpy fallback.

The library auto-builds ``libneighbor_kernels.so`` from the bundled source
on first use (g++ is part of the supported toolchain) into the package's
build directory ``dccrg_tpu_torch/_build/``; set ``DCCRG_TPU_NATIVE=0`` to
force the pure-numpy path.  This is host code (epoch metadata), not a
device kernel.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from ..core.neighbors import InconsistentGridError

__all__ = [
    "native_find_neighbors",
    "native_sort_unique_u64",
    "native_invert_and_pairs",
    "native_fill_tables",
    "native_delta_patch_tables",
    "native_available",
]

_DIR = pathlib.Path(__file__).resolve().parent
_BUILD_DIR = _DIR.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libneighbor_kernels.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DCCRG_TPU_NATIVE", "1") == "0":
        return None
    src = _DIR / "neighbor_kernels.cpp"
    try:
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < src.stat().st_mtime:
            # build beside the target and rename into place, so concurrent
            # first users (test workers) never load a half-written library
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [
                        "g++", "-O3", "-march=native", "-fopenmp", "-shared",
                        "-fPIC", "-o", tmp, str(src),
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.find_neighbors.restype = ctypes.c_int
    lib.find_neighbors.argtypes = [
        u64p, ctypes.c_int64,            # leaves
        u64p, ctypes.c_int,              # grid_len, max_ref
        u8p,                             # periodic
        i64p, ctypes.c_int64,            # hood
        u64p, ctypes.c_int64,            # src_cells
        ctypes.c_int,                    # uniform
        ctypes.c_int, ctypes.c_int,      # strict, emit
        i64p,                            # counts
        i64p,                            # out_start
        u64p, i64p, i64p, i32p,          # out_nbr, out_pos, out_offset, out_slot
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sort_unique_u64.restype = ctypes.c_int64
    lib.sort_unique_u64.argtypes = [u64p, ctypes.c_int64]
    lib.hood_invert_and_pairs.restype = ctypes.c_int64
    lib.hood_invert_and_pairs.argtypes = [
        i64p, i64p,                      # start, nbr_pos
        ctypes.c_int64, ctypes.c_int64,  # N, E
        i64p, ctypes.c_int64,            # owner, D
        i64p, i64p,                      # to_start, to_src
        u8p,                             # is_outer
        u64p, ctypes.POINTER(ctypes.c_int64),  # pair_bitmap, n_pairs
        i64p,                            # tmp
    ]
    lib.extract_pairs.restype = ctypes.c_int64
    lib.extract_pairs.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
    ]
    try:
        lib.delta_patch_tables.restype = None
        lib.delta_patch_tables.argtypes = [
            i32p, u8p, i32p, i32p, i32p,     # old tables (flattened)
            i64p, i64p, i64p,                # dst_rows, src_rows, counts
            ctypes.c_int64,                  # n_reuse
            i32p,                            # rowmap
            ctypes.c_int64, ctypes.c_int64,  # Kold, Kmin
            ctypes.c_int64,                  # Kmax (new width)
            i32p, u8p, i32p, i32p, i32p,     # new tables (flattened)
        ]
    except AttributeError:
        pass  # pre-delta .so still loads; numpy patch path engages
    lib.hood_fill_tables.restype = None
    lib.hood_fill_tables.argtypes = [
        i64p, i64p, i64p, i32p,          # start, nbr_pos, offset3, slot
        ctypes.c_int64, ctypes.c_int64,  # N, E
        i64p, i64p, i64p,                # owner, row_of, len_all
        i64p, i64p,                      # ghost_concat, ghost_start
        i64p,                            # n_local
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # D, R, Kmax
        i32p, u8p, i32p, i32p, i32p,     # tables
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def native_sort_unique_u64(keys: np.ndarray):
    """Parallel in-place sort + dedupe; returns the sorted unique prefix
    (a view of ``keys``) or None if the native library is unavailable.
    ``keys`` must be contiguous uint64 and is clobbered."""
    lib = _load()
    if lib is None:
        return None
    m = lib.sort_unique_u64(keys, len(keys))
    return keys[:m]


def native_find_neighbors(mapping, topology, leaves_cells, hood, src_cells, strict):
    """C++ fast path for find_all_neighbors; returns the CSR pieces
    (start, nbr_cell, nbr_pos, offset, slot) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_src = len(src_cells)
    grid_len = np.asarray(mapping.length, dtype=np.uint64)
    periodic = np.asarray(topology.periodic, dtype=np.uint8)
    hood = np.ascontiguousarray(hood, dtype=np.int64)
    leaves_cells = np.ascontiguousarray(leaves_cells, dtype=np.uint64)
    src_cells = np.ascontiguousarray(src_cells, dtype=np.uint64)
    # uniform level-0 grid: leaves are exactly [1..n0], so every position
    # lookup is id-1 — the per-edge binary search disappears
    n0 = int(np.prod(grid_len))
    uniform = int(
        len(leaves_cells) == n0
        and n0 > 0
        and leaves_cells[0] == 1
        and leaves_cells[-1] == n0
    )
    counts = np.zeros(n_src, dtype=np.int64)
    bad_cell = ctypes.c_uint64(0)
    bad_slot = ctypes.c_int64(0)
    dummy64 = np.zeros(1, dtype=np.int64)
    dummyu = np.zeros(1, dtype=np.uint64)
    dummy32 = np.zeros(1, dtype=np.int32)

    rc = lib.find_neighbors(
        leaves_cells, len(leaves_cells), grid_len, mapping.max_refinement_level,
        periodic, hood, len(hood), src_cells, n_src, uniform, int(strict), 0,
        counts, dummy64, dummyu, dummy64, dummy64, dummy32,
        ctypes.byref(bad_cell), ctypes.byref(bad_slot),
    )
    if rc:
        raise InconsistentGridError(
            f"inconsistent grid: no neighbor leaf for cell {bad_cell.value} "
            f"slot {tuple(hood[bad_slot.value])}"
        )
    start = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    E = int(start[-1])
    out_nbr = np.zeros(E, dtype=np.uint64)
    out_pos = np.zeros(E, dtype=np.int64)
    out_offset = np.zeros((E, 3), dtype=np.int64)
    out_slot = np.zeros(E, dtype=np.int32)
    rc = lib.find_neighbors(
        leaves_cells, len(leaves_cells), grid_len, mapping.max_refinement_level,
        periodic, hood, len(hood), src_cells, n_src, uniform, int(strict), 1,
        counts, start, out_nbr, out_pos,
        out_offset.reshape(-1), out_slot,
        ctypes.byref(bad_cell), ctypes.byref(bad_slot),
    )
    if rc:
        raise InconsistentGridError(
            f"neighbor {bad_cell.value} is not an existing leaf (2:1 violation?)"
        )
    return start, out_nbr, out_pos, out_offset, out_slot


def native_invert_and_pairs(start, nbr_pos, owner, n_devices):
    """Fused inverse-CSR + ghost-pair + inner/outer pass (C++).  Returns
    ``(to_start, to_src, pairs, is_outer)`` or None if unavailable or the
    D*N pair bitmap would be unreasonably large."""
    lib = _load()
    if lib is None:
        return None
    N = len(start) - 1
    E = int(start[-1])
    D = int(n_devices)
    n_bits = D * max(N, 1)
    if n_bits > (1 << 33):         # 1 GiB of bitmap — fall back to numpy
        return None
    start = np.ascontiguousarray(start, dtype=np.int64)
    nbr_pos = np.ascontiguousarray(nbr_pos, dtype=np.int64)
    owner = np.ascontiguousarray(owner, dtype=np.int64)
    to_start = np.zeros(N + 1, dtype=np.int64)
    to_src = np.zeros(max(E, 1), dtype=np.int64)
    is_outer = np.zeros(max(N, 1), dtype=np.uint8)
    bitmap = np.zeros((n_bits + 63) // 64, dtype=np.uint64)
    tmp = np.empty(max(N, 1), dtype=np.int64)  # per-bucket cursors
    n_pairs = ctypes.c_int64(0)
    n_to = lib.hood_invert_and_pairs(
        start, nbr_pos, N, E, owner, D,
        to_start, to_src, is_outer, bitmap, ctypes.byref(n_pairs), tmp,
    )
    out_dev = np.zeros(max(n_pairs.value, 1), dtype=np.int64)
    out_pos = np.zeros(max(n_pairs.value, 1), dtype=np.int64)
    k = lib.extract_pairs(bitmap, D, max(N, 1), out_dev, out_pos)
    assert k == n_pairs.value
    pairs = np.stack([out_dev[:k], out_pos[:k]], axis=1)
    return to_start, to_src[:n_to], pairs, is_outer.astype(bool)[:N]


def native_delta_patch_tables(
    old_rows, old_valid, old_offset, old_len, old_slot,
    dst_rows, src_rows, row_counts, rowmap, kmin,
    new_rows, new_valid, new_offset, new_len, new_slot,
):
    """Fused per-device gather-table patch (C++): one OpenMP sweep copies
    every reused row ``src_rows[i] -> dst_rows[i]`` across all five
    tables at once — only the row's ``row_counts[i]`` live columns, the
    rest is pad on both sides — pushing ``nbr_rows`` values through the
    old-row -> new-row map.  The incremental-epoch replacement for five
    separate numpy passes.  Returns True, or False if the native library
    is unavailable (caller runs the numpy patch)."""
    lib = _load()
    if lib is None or getattr(lib, "delta_patch_tables", None) is None:
        return False
    lib.delta_patch_tables(
        old_rows.reshape(-1),
        old_valid.view(np.uint8).reshape(-1),
        old_offset.reshape(-1),
        old_len.reshape(-1),
        old_slot.reshape(-1),
        np.ascontiguousarray(dst_rows, dtype=np.int64),
        np.ascontiguousarray(src_rows, dtype=np.int64),
        np.ascontiguousarray(row_counts, dtype=np.int64),
        len(dst_rows),
        np.ascontiguousarray(rowmap, dtype=np.int32),
        int(old_rows.shape[1]), int(kmin), int(new_rows.shape[1]),
        new_rows.reshape(-1), new_valid.view(np.uint8).reshape(-1),
        new_offset.reshape(-1), new_len.reshape(-1), new_slot.reshape(-1),
    )
    return True


def native_fill_tables(
    start, nbr_pos, offset3, slot, owner, row_of, len_all,
    ghost_pos_lists, n_local, D, R, Kmax,
    nbr_rows, nbr_valid, nbr_offset, nbr_len, nbr_slot,
):
    """Fused gather-table fill (C++): writes the five pre-allocated
    (D, R, Kmax[, 3]) tables in one sweep.  Returns True, or False if the
    native library is unavailable (caller uses the numpy path)."""
    lib = _load()
    if lib is None:
        return False
    N = len(start) - 1
    E = int(start[-1])
    ghost_start = np.zeros(D + 1, dtype=np.int64)
    np.cumsum([len(g) for g in ghost_pos_lists], out=ghost_start[1:])
    ghost_concat = (
        np.ascontiguousarray(np.concatenate(ghost_pos_lists), dtype=np.int64)
        if ghost_start[-1]
        else np.zeros(1, dtype=np.int64)
    )
    lib.hood_fill_tables(
        np.ascontiguousarray(start, dtype=np.int64),
        np.ascontiguousarray(nbr_pos, dtype=np.int64),
        np.ascontiguousarray(offset3, dtype=np.int64).reshape(-1),
        np.ascontiguousarray(slot, dtype=np.int32),
        N, E,
        np.ascontiguousarray(owner, dtype=np.int64),
        np.ascontiguousarray(row_of, dtype=np.int64),
        np.ascontiguousarray(len_all, dtype=np.int64),
        ghost_concat, ghost_start,
        np.ascontiguousarray(n_local, dtype=np.int64),
        int(D), int(R), int(Kmax),
        nbr_rows.reshape(-1), nbr_valid.view(np.uint8).reshape(-1),
        nbr_offset.reshape(-1), nbr_len.reshape(-1), nbr_slot.reshape(-1),
    )
    return True
