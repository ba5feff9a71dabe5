"""Checkpoint/restart: the reference's ".dc" format semantics, hardened.

Layout follows ``save_grid_data`` (``dccrg.hpp:1089-1716``): a user header,
an endianness magic, self-describing grid metadata (mapping, neighborhood
length, topology periodicity, geometry id + parameters), the total cell
count, a cell-id/byte-offset table, then per-cell payload bytes.  The
offset table makes the file loadable with ANY device count: load
re-initializes a level-0 grid, replays refinement from the saved leaf ids
(``load_cells``, ``dccrg.hpp:3647-3716``), and scatters payloads wherever
the new partition puts each cell.

Variable-size per-cell payloads are first-class, mirroring the reference's
size-prefixed variable data (``tests/restart/IO.hpp``, chunked loading via
repeated ``continue_loading_grid_data``, ``dccrg.hpp:2085-2368``): a field
may be declared *ragged* by naming its count field — only ``count[i]`` rows
of its padded buffer are written per cell, so each cell's byte offset is
genuinely its own.  Loading is chunked through the same
``start_/continue_/finish_loading_grid_data`` triple the reference exposes.

Format **version 2** (the default) wraps the same logical
content in an integrity envelope so torn writes and media corruption are
*detected* instead of parsed as garbage:

.. code-block:: text

    [ 8] magic  b"DCCRG2\\r\\n"
    [ 8] <Q  header block length H
    [ H] header block  == the complete v1 metadata prefix
         (<I hlen, user header, <Q endianness magic, mapping,
          <I hood length, topology, <i geometry id, geometry params,
          <Q n_cells)
    [ 4] <I  CRC32(header block)
    [  ] cell table    n_cells * (<Q cell id, <Q payload offset)
    [  ] cell CRCs     n_cells * <I CRC32(that cell's payload chunk)
    [ 8] <Q  total payload bytes
    [ 4] <I  CRC32(cell table + cell CRCs + payload length)
    [  ] payload

Version-1 files (no magic) still load — the reader sniffs the first 8
bytes.  Every truncated or corrupt read raises a typed
:class:`CheckpointError` naming the failing section (never a bare
``struct.error``/``EOFError``), CRC mismatches are counted in telemetry
(``checkpoint.crc_failures{section=...}``), and ``on_error="salvage"``
recovers every intact cell of a damaged file and reports the lost id set
— the per-cell CRCs make single-cell loss possible instead of
whole-file loss.

Byte-for-byte compatibility with the C++ reference is NOT a goal (its
payload bytes are whatever ``get_mpi_datatype`` says); the logical content
and reload-anywhere property are.  The format is the JAX package's
(``dccrg_tpu/io/checkpoint.py``) byte for byte: a file either package
writes loads in the other.

This package runs in one process, which writes: the JAX package's
multi-controller fan-in is left out.  Readback from the device is one
``.cpu()`` a field.  Telemetry is the JAX package's: the
``checkpoint.write`` and ``checkpoint.read`` phases, and the counters
``checkpoint.bytes_written`` / ``cells_written`` / ``bytes_read`` /
``cells_read``, ``checkpoint.crc_failures{section}``,
``checkpoint.errors{section}`` (truncations), ``checkpoint.cells_lost`` and
``checkpoint.cells_salvaged``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..obs.registry import metrics
from ..utils.setops import ragged_arange as _ragged_arange

__all__ = [
    "save_grid_data",
    "load_grid_data",
    "start_loading_grid_data",
    "quick_validate",
    "GridLoader",
    "CheckpointError",
    "ENDIANNESS_MAGIC",
    "V2_MAGIC",
    "CHECKPOINT_VERSION",
]

#: same magic the reference writes (dccrg.hpp:1234-1247)
ENDIANNESS_MAGIC = 0x1234567890ABCDEF

#: leading magic of the hardened (CRC-carrying) format; version-1 files
#: start with a little-endian user-header length instead, which cannot
#: collide with these bytes for any plausible header size
V2_MAGIC = b"DCCRG2\r\n"

#: the format ``save_grid_data`` writes by default
CHECKPOINT_VERSION = 2


class CheckpointError(ValueError):
    """A checkpoint file is torn, corrupt, or inconsistent.

    ``section`` names the failing part of the file (``"user_header"``,
    ``"magic"``, ``"mapping"``, ``"neighborhood"``, ``"topology"``,
    ``"geometry"``, ``"header"``, ``"cell_table"``, ``"payload"``,
    ``"lineage"``, ``"manifest"``); ``path`` is the file (when known);
    ``lost_cells`` carries the unrecoverable cell ids when a salvage
    attempt itself gives up.  Subclasses ``ValueError`` so pre-hardening
    callers that caught ``ValueError`` keep working.
    """

    def __init__(self, section: str, message: str, path: str | None = None,
                 lost_cells=None):
        self.section = str(section)
        self.path = path
        self.lost_cells = lost_cells
        where = f" [{path}]" if path else ""
        super().__init__(f"checkpoint {self.section}: {message}{where}")


def _read_exact(f, n: int, section: str, path: str | None) -> bytes:
    """Read exactly ``n`` bytes or raise a typed truncation error."""
    b = f.read(n)
    if len(b) != n:
        metrics.inc("checkpoint.errors", section=section)
        raise CheckpointError(
            section,
            f"file truncated: wanted {n} bytes, got {len(b)}",
            path,
        )
    return b


def _crc_fail(section: str, path: str | None) -> None:
    metrics.inc("checkpoint.crc_failures", section=section)
    raise CheckpointError(section, "CRC32 mismatch (corrupt bytes)", path)


def _field_layout(spec, ragged):
    """Split spec into fixed fields and ragged fields.

    Returns (fixed, ragged_fields) where fixed is a list of
    (name, shape, dtype, nbytes) written whole per cell, and ragged_fields
    is a list of (name, count_field, row_shape, dtype, row_nbytes) written
    as count[i] rows per cell.  Count fields themselves are fixed fields.
    """
    ragged = ragged or {}
    for field, count_field in ragged.items():
        if field not in spec:
            raise ValueError(f"ragged field {field!r} not in spec")
        if count_field not in spec:
            raise ValueError(f"count field {count_field!r} not in spec")
        if len(spec[field][0]) < 1:
            raise ValueError(f"ragged field {field!r} needs a leading pad axis")
    fixed, ragged_fields = [], []
    for name, (shape, dt) in spec.items():
        dt = np.dtype(dt)
        if name in ragged:
            row_shape = tuple(shape[1:])
            row_nb = int(np.prod(row_shape, dtype=np.int64)) * dt.itemsize
            ragged_fields.append((name, ragged[name], row_shape, dt, row_nb))
        else:
            nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            fixed.append((name, tuple(shape), dt, nb))
    return fixed, ragged_fields


def save_grid_data(grid, state, path: str, spec, user_header: bytes = b"",
                   ragged=None, version: int = CHECKPOINT_VERSION) -> None:
    """Write grid structure + payloads of all cells to one file.

    ``ragged`` maps field name -> count-field name for variable-size
    payloads: only ``count[i]`` leading rows of the field are stored for
    cell ``i`` (reference: runtime-switched ``get_mpi_datatype``,
    ``tests/particles/cell.hpp:50-84``).  ``version=1`` writes the
    legacy CRC-less layout (the default v2 envelope is described in the
    module docstring); both load transparently.

    The file is written to ``path + ".tmp"``, fsync'd, renamed over
    ``path`` and the directory entry fsync'd, so a failed write never
    leaves a truncated checkpoint at the final path.

    Telemetry: the whole save (readbacks + write) is the
    ``checkpoint.write`` phase; ``checkpoint.bytes_written`` counts the
    payload + cell-table bytes.
    """
    if version not in (1, 2):
        raise ValueError(f"unknown checkpoint version {version}")
    with metrics.phase("checkpoint.write"):
        _save_grid_data(grid, state, path, spec, user_header, ragged, version)


def _save_grid_data(grid, state, path, spec, user_header, ragged,
                    version) -> None:
    cells = grid.get_cells()
    fixed, ragged_fields = _field_layout(spec, ragged)

    per_cell = {}
    for name, (shape, dt) in spec.items():
        vals = grid.get_cell_data(state, name, cells)
        per_cell[name] = np.ascontiguousarray(vals, dtype=dt)

    counts = {}
    for name, count_field, row_shape, dt, row_nb in ragged_fields:
        c = per_cell[count_field].astype(np.int64).reshape(len(cells))
        pad = spec[name][0][0]
        if (c < 0).any() or (c > pad).any():
            raise ValueError(f"count field {count_field!r} outside [0, {pad}]")
        counts[name] = c

    fixed_bpc = sum(nb for _, _, _, nb in fixed)
    bytes_per_cell = np.full(len(cells), fixed_bpc, dtype=np.int64)
    for name, _, _, _, row_nb in ragged_fields:
        bytes_per_cell += counts[name] * row_nb
    offsets = np.concatenate(([0], np.cumsum(bytes_per_cell[:-1])))
    metrics.inc("checkpoint.bytes_written",
                int(bytes_per_cell.sum()) + len(cells) * 16)
    metrics.inc("checkpoint.cells_written", len(cells))

    tmp = path + ".tmp"
    _write_checkpoint(tmp, grid, cells, spec, user_header, fixed,
                      ragged_fields, per_cell, counts, bytes_per_cell,
                      offsets, fixed_bpc, version)
    os.replace(tmp, path)
    _fsync_dir(path)


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename survives power loss (best
    effort — not every platform allows opening directories)."""
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                      os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def _meta_block(grid, user_header: bytes, n_cells: int) -> bytes:
    """The self-describing metadata prefix — identical byte content in
    both format versions (v1 writes it at file start, v2 wraps it in the
    length + CRC envelope)."""
    mapping, topo, geom = grid.mapping, grid.topology, grid.geometry
    parts = [
        struct.pack("<I", len(user_header)),
        user_header,
        struct.pack("<Q", ENDIANNESS_MAGIC),
        mapping.to_file_bytes(),
        struct.pack("<I", grid._hood_length),
        topo.to_file_bytes(),
        struct.pack("<i", geom.geometry_id),
        geom.params_to_file_bytes(),
        struct.pack("<Q", n_cells),
    ]
    return b"".join(parts)


def _write_checkpoint(path, grid, cells, spec, user_header, fixed,
                      ragged_fields, per_cell, counts, bytes_per_cell,
                      offsets, fixed_bpc, version) -> None:
    # imported here: the resilience package's lineage imports this module
    from ..resilience import inject

    n_cells_ = len(cells)
    # payloads: per cell, fixed fields in spec order, then ragged rows.
    # All packing is offset-indexed scatter — no per-cell Python loops
    # (O(N) Python loops crawled at million-cell scale)
    total = int(bytes_per_cell.sum())
    blob = np.empty(total, dtype=np.uint8)
    cursor = offsets.copy()
    if not ragged_fields:
        # constant stride: the blob is just a [N, bytes_per_cell] table
        view = blob.reshape(n_cells_, fixed_bpc) if n_cells_ else blob
        col = 0
        for name, shape, dt, nb in fixed:
            flat = per_cell[name].reshape(n_cells_, -1)
            view[:, col : col + nb] = (
                np.ascontiguousarray(flat).view(np.uint8).reshape(n_cells_, nb)
            )
            col += nb
    else:
        for name, shape, dt, nb in fixed:
            flat = per_cell[name].reshape(n_cells_, -1)
            raw = np.ascontiguousarray(flat).view(np.uint8).reshape(n_cells_, nb)
            dest = (cursor[:, None] + np.arange(nb, dtype=np.int64)).ravel()
            blob[dest] = raw.ravel()
            cursor += nb
        for name, count_field, row_shape, dt, row_nb in ragged_fields:
            pad = spec[name][0][0]
            cnt = counts[name]
            data = per_cell[name].reshape(n_cells_, pad, -1)
            raw = np.ascontiguousarray(data).view(np.uint8).reshape(
                n_cells_, pad, row_nb
            )
            valid = np.arange(pad, dtype=np.int64)[None, :] < cnt[:, None]
            lens = cnt * row_nb
            dest = np.repeat(cursor, lens) + _ragged_arange(lens)
            blob[dest] = raw[valid].ravel()
            cursor += lens

    table = np.empty((n_cells_, 2), dtype="<u8")
    table[:, 0] = cells
    table[:, 1] = offsets.astype(np.uint64)

    if version >= 2:
        # per-cell payload CRCs from the PRISTINE blob: a later bit flip
        # (injected here, or real media corruption) is detectable per
        # cell, which is what makes salvage cell-granular
        bounds = np.concatenate((offsets, [total])).tolist()
        mv = blob.data
        cell_crcs = np.empty(n_cells_, dtype="<u4")
        for i in range(n_cells_):
            cell_crcs[i] = zlib.crc32(mv[bounds[i]:bounds[i + 1]])

    # fault injection: a flipped bit in the saved payload bytes (after
    # the CRCs above — the flip models corruption the CRCs must catch)
    inject.corrupt_array(blob)

    with open(path, "wb") as f:
        if version >= 2:
            head = _meta_block(grid, user_header, n_cells_)
            f.write(V2_MAGIC)
            f.write(struct.pack("<Q", len(head)))
            f.write(head)
            f.write(struct.pack("<I", zlib.crc32(head)))
            tb = (table.tobytes() + cell_crcs.tobytes()
                  + struct.pack("<Q", total))
            f.write(tb)
            f.write(struct.pack("<I", zlib.crc32(tb)))
        else:
            f.write(_meta_block(grid, user_header, n_cells_))
            f.write(table.tobytes())
        f.write(blob.tobytes())
        f.flush()
        # fault injection: a torn write — the file loses its tail as if
        # the process died mid-write (detected by the v2 payload-length
        # field + CRCs; the lineage manager must skip such a generation)
        frac = inject.torn_fraction()
        if frac is not None:
            f.truncate(max(1, int(f.tell() * frac)))
        os.fsync(f.fileno())


def _parse_meta(f, path):
    """Parse the self-describing metadata prefix from the stream's
    current position (a file for v1, a BytesIO over the CRC-validated
    header block for v2).  Returns ``(user_header, mapping, hood_len,
    topology, geom_cls, geometry, n_cells)``; every truncated or
    malformed section raises :class:`CheckpointError`."""
    from ..core.mapping import Mapping
    from ..core.topology import Topology
    from ..geometry import geometry_from_id

    (hlen,) = struct.unpack("<I", _read_exact(f, 4, "user_header", path))
    user_header = _read_exact(f, int(hlen), "user_header", path)
    (magic,) = struct.unpack("<Q", _read_exact(f, 8, "magic", path))
    if magic != ENDIANNESS_MAGIC:
        raise CheckpointError(
            "magic", f"bad endianness magic {magic:#x}", path
        )
    try:
        mapping = Mapping.from_file_bytes(
            _read_exact(f, Mapping.FILE_DATA_SIZE, "mapping", path)
        )
    except (ValueError, struct.error) as e:
        if isinstance(e, CheckpointError):
            raise
        raise CheckpointError("mapping", str(e), path) from e
    (hood_len,) = struct.unpack(
        "<I", _read_exact(f, 4, "neighborhood", path)
    )
    try:
        topo = Topology.from_file_bytes(
            _read_exact(f, Topology.FILE_DATA_SIZE, "topology", path)
        )
    except (ValueError, struct.error) as e:
        if isinstance(e, CheckpointError):
            raise
        raise CheckpointError("topology", str(e), path) from e
    (geom_id,) = struct.unpack("<i", _read_exact(f, 4, "geometry", path))
    try:
        geom_cls = geometry_from_id(geom_id)
    except (ValueError, KeyError) as e:
        raise CheckpointError("geometry", str(e), path) from e
    # geometry parameter block has data-dependent size: read in
    # doubling chunks until it parses (stays tiny in practice)
    geom_pos = f.tell()
    buf, want = b"", 1 << 16
    while True:
        buf += f.read(want - len(buf))
        try:
            geometry, used = geom_cls.params_from_file_bytes(
                buf, mapping, topo
            )
            break
        except (ValueError, struct.error) as e:
            if len(buf) < want:  # EOF — params truncated or malformed
                raise CheckpointError(
                    "geometry",
                    f"geometry parameters truncated or malformed: {e}",
                    path,
                ) from e
            want *= 2
    f.seek(geom_pos + used)
    (n_cells,) = struct.unpack("<Q", _read_exact(f, 8, "cell_table", path))
    return user_header, mapping, int(hood_len), topo, geom_cls, geometry, \
        int(n_cells)


def quick_validate(path: str) -> int:
    """Envelope-level integrity check WITHOUT rebuilding the grid:
    header CRC, table CRC, and the payload-length bookkeeping for v2
    files; metadata parse + table/payload extent for v1.  Cost is
    O(header + cell table) — no payload read, no per-cell CRCs, no
    epoch build — which is what makes it cheap enough to run at every
    lineage commit.  Returns the format version; raises
    :class:`CheckpointError` naming the failing section."""
    with open(path, "rb") as f:
        first = f.read(len(V2_MAGIC))
        if first == V2_MAGIC:
            (hlen,) = struct.unpack("<Q", _read_exact(f, 8, "header", path))
            if hlen > (1 << 32):
                raise CheckpointError(
                    "header", f"implausible header length {hlen}", path
                )
            head = _read_exact(f, int(hlen), "header", path)
            (hcrc,) = struct.unpack("<I", _read_exact(f, 4, "header", path))
            if zlib.crc32(head) != hcrc:
                _crc_fail("header", path)
            if len(head) < 8:
                raise CheckpointError("header", "header block too short",
                                      path)
            (n_cells,) = struct.unpack("<Q", head[-8:])
            tlen = int(n_cells) * 20 + 8
            tb = _read_exact(f, tlen, "cell_table", path)
            (tcrc,) = struct.unpack(
                "<I", _read_exact(f, 4, "cell_table", path)
            )
            if zlib.crc32(tb) != tcrc:
                _crc_fail("cell_table", path)
            (payload_total,) = struct.unpack("<Q", tb[-8:])
            payload_start = f.tell()
            f.seek(0, 2)
            if f.tell() - payload_start < payload_total:
                metrics.inc("checkpoint.errors", section="payload")
                raise CheckpointError(
                    "payload",
                    f"payload truncated: {f.tell() - payload_start} of "
                    f"{payload_total} bytes on disk",
                    path,
                )
            return 2
        f.seek(0)
        *_rest, n_cells = _parse_meta(f, path)
        tb = _read_exact(f, n_cells * 16, "cell_table", path)
        if n_cells:
            offsets = np.frombuffer(tb, dtype="<u8").reshape(n_cells, 2)[:, 1]
            payload_start = f.tell()
            f.seek(0, 2)
            if f.tell() - payload_start < int(offsets[-1]):
                metrics.inc("checkpoint.errors", section="payload")
                raise CheckpointError(
                    "payload", "payload truncated before last cell", path
                )
        return 1


class GridLoader:
    """Chunked checkpoint loading — the reference's ``start_loading_grid_data``
    / ``continue_loading_grid_data`` / ``finish_loading_grid_data`` triple
    (``dccrg.hpp:1742-2404``).

    ``start`` reads the metadata prefix (NOT the payload — that stays on
    disk), rebuilds the grid structure on ``n_devices`` slots of
    ``device`` (default CUDA) from the saved leaf set, and allocates a
    host-side mirror of the fields; each ``continue_loading_grid_data``
    call reads the byte range of up to ``max_cells`` more cells from the
    file into the mirror, so host memory beyond the final state is bounded
    by one chunk of payload; ``finish_loading_grid_data`` moves the mirror
    to the device (one transfer per field) and returns ``(grid, state,
    user_header)``.

    ``on_error`` selects the damage policy: ``"raise"`` (default) turns
    any truncation or CRC mismatch into a :class:`CheckpointError`
    naming the failing section; ``"salvage"`` recovers every cell whose
    payload chunk is intact (v2 CRCs make that cell-granular) and
    reports the unrecoverable ids in :attr:`lost_cells` — lost cells'
    fields stay at ``new_state``'s fill.  Grid *structure* (header +
    cell table) must be intact in either mode; without it there is
    nothing to salvage into.
    """

    def __init__(self, path: str, spec, n_devices=None, device=None,
                 ragged=None, load_balancing_method: str = "RCB",
                 on_error: str = "raise"):
        if on_error not in ("raise", "salvage"):
            raise ValueError(f"on_error must be 'raise' or 'salvage', "
                             f"got {on_error!r}")
        self.on_error = on_error
        self._lost_idx: set = set()
        with metrics.phase("checkpoint.read"):
            self._init_impl(path, spec, n_devices, device, ragged,
                            load_balancing_method)

    def _init_impl(self, path, spec, n_devices, device, ragged,
                   load_balancing_method):
        from ..grid import Grid

        self.spec = spec
        self._path = path
        self._fixed, self._ragged = _field_layout(spec, ragged)

        with open(path, "rb") as f:
            first = f.read(len(V2_MAGIC))
            if first == V2_MAGIC:
                self.version = 2
                (hlen,) = struct.unpack(
                    "<Q", _read_exact(f, 8, "header", path)
                )
                if hlen > (1 << 32):
                    raise CheckpointError(
                        "header", f"implausible header length {hlen}", path
                    )
                head = _read_exact(f, int(hlen), "header", path)
                (hcrc,) = struct.unpack(
                    "<I", _read_exact(f, 4, "header", path)
                )
                if zlib.crc32(head) != hcrc:
                    _crc_fail("header", path)
                import io as _io

                (self.user_header, mapping, hood_len, topo, geom_cls,
                 geometry, n_cells) = _parse_meta(_io.BytesIO(head), path)
                tlen = n_cells * 16 + n_cells * 4 + 8
                tb = _read_exact(f, tlen, "cell_table", path)
                (tcrc,) = struct.unpack(
                    "<I", _read_exact(f, 4, "cell_table", path)
                )
                if zlib.crc32(tb) != tcrc:
                    _crc_fail("cell_table", path)
                table = np.frombuffer(
                    tb, dtype="<u8", count=2 * n_cells
                ).reshape(n_cells, 2)
                self._cell_crcs = np.frombuffer(
                    tb, dtype="<u4", offset=n_cells * 16, count=n_cells
                )
                (payload_total,) = struct.unpack("<Q", tb[-8:])
                self._payload_start = f.tell()
                f.seek(0, 2)
                avail = f.tell() - self._payload_start
                self._payload_size = int(payload_total)
                self._payload_avail = min(int(avail), int(payload_total))
                if avail < payload_total and self.on_error != "salvage":
                    metrics.inc("checkpoint.errors", section="payload")
                    raise CheckpointError(
                        "payload",
                        f"payload truncated: {avail} of {payload_total} "
                        "bytes on disk",
                        path,
                    )
            else:
                self.version = 1
                f.seek(0)
                (self.user_header, mapping, hood_len, topo, geom_cls,
                 geometry, n_cells) = _parse_meta(f, path)
                tb = _read_exact(f, n_cells * 16, "cell_table", path)
                table = np.frombuffer(tb, dtype="<u8").reshape(n_cells, 2)
                self._cell_crcs = None
                self._payload_start = f.tell()
                f.seek(0, 2)
                self._payload_size = f.tell() - self._payload_start
                self._payload_avail = self._payload_size

        self.saved_cells = table[:, 0].astype(np.uint64)
        self._offsets = table[:, 1].astype(np.int64)
        if n_cells and (np.diff(self._offsets) < 0).any():
            raise CheckpointError(
                "cell_table", "payload offsets not ascending", path
            )
        self._n_cells = int(n_cells)
        self._loaded = 0
        # host mirror, scattered to devices once at finish
        self._host = {
            name: np.zeros((self._n_cells,) + tuple(shape), dtype=dt)
            for name, (shape, dt) in spec.items()
        }

        # --- rebuild grid structure (reference start_loading_grid_data:
        # metadata + level-0 grid + load_cells refinement replay)
        grid = (
            Grid()
            .set_initial_length(mapping.length)
            .set_maximum_refinement_level(mapping.max_refinement_level)
            .set_periodic(*topo.periodic)
            .set_neighborhood_length(hood_len)
            .set_load_balancing_method(load_balancing_method)
        )
        grid._geometry_factory = lambda m, t: geom_cls.params_from_file_bytes(
            geometry.params_to_file_bytes(), m, t
        )[0]
        # direct leaf-set construction: the saved set is a valid 2:1
        # forest, so derived state builds ONCE (initialize validates
        # tiling + 2:1 and raises on a corrupt file) — in place of the
        # reference's level-by-level refinement replay
        # (dccrg.hpp:3647-3716), which costs one full rebuild per
        # refinement level
        saved = self.saved_cells
        grid.initialize(n_devices=n_devices, device=device, leaf_set=saved)
        grid.balance_load()
        self.grid = grid

    # ------------------------------------------------------------------

    @property
    def lost_cells(self) -> np.ndarray:
        """Ids of cells whose payload could not be recovered (salvage
        mode only; empty until their chunks have been visited)."""
        idx = np.asarray(sorted(self._lost_idx), dtype=np.int64)
        return self.saved_cells[idx] if len(idx) else \
            np.zeros(0, dtype=np.uint64)

    def continue_loading_grid_data(self, max_cells: int | None = None) -> bool:
        """Read the payloads of the next ``max_cells`` saved cells from the
        file into the host mirror.  Returns True while more cells remain
        (call again)."""
        if max_cells is not None and max_cells < 1:
            raise ValueError("max_cells must be >= 1")
        if self._loaded >= self._n_cells:
            return False
        lo = self._loaded
        hi = self._n_cells if max_cells is None else min(lo + int(max_cells),
                                                         self._n_cells)
        n = hi - lo
        offs = self._offsets
        start = int(offs[lo])
        end = int(offs[hi]) if hi < self._n_cells else self._payload_size
        with metrics.phase("checkpoint.read"):
            with open(self._path, "rb") as f:
                f.seek(self._payload_start + start)
                payload = f.read(end - start)
        if len(payload) < end - start and self.on_error != "salvage":
            metrics.inc("checkpoint.errors", section="payload")
            raise CheckpointError(
                "payload",
                f"payload truncated: wanted {end - start} bytes for cells "
                f"[{lo}, {hi}), got {len(payload)}",
                self._path,
            )
        metrics.inc("checkpoint.bytes_read", len(payload))
        metrics.inc("checkpoint.cells_read", n)

        pay = np.frombuffer(payload, dtype=np.uint8)
        # chunk-local [start, end) boundaries per cell — the integrity
        # unit (the offsets are contiguous by construction, so cell i's
        # payload is exactly [bounds[i], bounds[i+1]))
        bounds = np.empty(n + 1, dtype=np.int64)
        bounds[:n] = offs[lo:hi] - start
        bounds[n] = end - start

        intact = bounds[1:] <= len(pay)  # fully-on-disk cells
        n_trunc = int((~intact).sum())
        if self.version >= 2:
            bl = bounds.tolist()
            crcs = self._cell_crcs[lo:hi]
            mv = memoryview(payload)
            for i in range(n):
                if intact[i] and zlib.crc32(mv[bl[i]:bl[i + 1]]) != int(crcs[i]):
                    intact[i] = False
        bad = np.flatnonzero(~intact)
        if len(bad):
            if len(bad) > n_trunc:
                metrics.inc("checkpoint.crc_failures",
                            int(len(bad) - n_trunc), section="payload")
            if n_trunc:
                metrics.inc("checkpoint.errors", n_trunc, section="payload")
            if self.on_error != "salvage":
                cell = int(self.saved_cells[lo + int(bad[0])])
                more = f" (+{len(bad) - 1} more in chunk)" if len(bad) > 1 \
                    else ""
                raise CheckpointError(
                    "payload",
                    f"CRC mismatch in payload of cell {cell}{more}",
                    self._path,
                )
            self._lost_idx.update(int(lo + b) for b in bad)
        sel = np.flatnonzero(intact)
        if len(sel) == 0:
            self._loaded = hi
            return self._loaded < self._n_cells

        # fixed fields, spec order — offset-indexed gather, no per-cell loop
        if len(sel) == n and not self._ragged:
            # constant stride: the chunk is a [n, bytes_per_cell] table
            view = pay.reshape(n, -1)
            col = 0
            for name, shape, dt, nb in self._fixed:
                vals = (
                    np.ascontiguousarray(view[:, col : col + nb])
                    .view(dt)
                    .reshape((n,) + shape)
                )
                col += nb
                self._host[name][lo:hi] = vals
            self._loaded = hi
            return self._loaded < self._n_cells

        cursor = bounds[:n][sel].copy()
        rows = lo + sel
        chunk_fixed = {}
        for name, shape, dt, nb in self._fixed:
            idx = cursor[:, None] + np.arange(nb, dtype=np.int64)
            vals = pay[idx].view(dt).reshape((len(sel),) + shape)
            cursor = cursor + nb
            chunk_fixed[name] = vals
            self._host[name][rows] = vals
        # ragged fields: count[i] rows, padded back out to the spec shape
        for name, count_field, row_shape, dt, row_nb in self._ragged:
            pad = self.spec[name][0][0]
            cnt = chunk_fixed[count_field].astype(np.int64).reshape(len(sel))
            if (cnt < 0).any() or (cnt > pad).any():
                raise CheckpointError(
                    "payload",
                    f"count field {count_field!r} outside [0, {pad}]",
                    self._path,
                )
            lens = cnt * row_nb
            src = np.repeat(cursor, lens) + _ragged_arange(lens)
            packed = pay[src].reshape(-1, row_nb).view(dt)
            valid = np.arange(pad, dtype=np.int64)[None, :] < cnt[:, None]
            out = np.zeros((len(sel), pad) + row_shape, dtype=dt)
            out[valid] = packed.reshape((-1,) + row_shape)
            self._host[name][rows] = out
            cursor = cursor + lens
        self._loaded = hi
        return self._loaded < self._n_cells

    def finish_loading_grid_data(self):
        """Move the host mirror to the grid's device (one transfer per
        field) and return the completed ``(grid, state, user_header)``.  In
        salvage mode, lost cells keep ``new_state``'s fill and their ids
        are in :attr:`lost_cells`."""
        if self._loaded < self._n_cells:
            raise RuntimeError(
                f"only {self._loaded}/{self._n_cells} cells loaded — call "
                "continue_loading_grid_data until it returns False"
            )
        if self._lost_idx:
            keep = np.ones(self._n_cells, dtype=bool)
            keep[np.asarray(sorted(self._lost_idx), dtype=np.int64)] = False
            cells = self.saved_cells[keep]
            metrics.inc("checkpoint.cells_lost", int((~keep).sum()))
            metrics.inc("checkpoint.cells_salvaged", int(keep.sum()))
        else:
            keep = None
            cells = self.saved_cells
        state = self.grid.state_from_host(
            self.spec, cells,
            {name: v if keep is None else v[keep]
             for name, v in self._host.items()})
        self._host = {}
        return self.grid, state, self.user_header


def start_loading_grid_data(path: str, spec, n_devices=None, device=None,
                            ragged=None,
                            load_balancing_method: str = "RCB",
                            on_error: str = "raise") -> GridLoader:
    """Open a checkpoint and rebuild the grid structure; payloads are then
    pulled in chunks with ``loader.continue_loading_grid_data()``."""
    return GridLoader(path, spec, n_devices=n_devices, device=device,
                      ragged=ragged,
                      load_balancing_method=load_balancing_method,
                      on_error=on_error)


def load_grid_data(path: str, spec, n_devices=None, device=None, ragged=None,
                   load_balancing_method: str = "RCB",
                   on_error: str = "raise"):
    """One-shot load: ``start`` + drain ``continue`` + ``finish``.

    Returns ``(grid, state, user_header)``; with ``on_error="salvage"``
    returns ``(grid, state, user_header, lost_cells)`` where
    ``lost_cells`` is the (possibly empty) uint64 id array of cells
    whose payload could not be recovered.  Works with any slot count:
    structure is rebuilt, payloads scattered by the new partition.
    """
    loader = start_loading_grid_data(
        path, spec, n_devices=n_devices, device=device, ragged=ragged,
        load_balancing_method=load_balancing_method, on_error=on_error,
    )
    while loader.continue_loading_grid_data():
        pass
    grid, state, user_header = loader.finish_loading_grid_data()
    if on_error == "salvage":
        return grid, state, user_header, loader.lost_cells
    return grid, state, user_header
