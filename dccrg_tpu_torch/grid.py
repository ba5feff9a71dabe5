"""The Grid: dccrg's user model on CUDA devices (PyTorch).

The same fluent surface as the JAX package's ``Grid`` (builder ->
``initialize`` -> cells, payloads, refinement, halo), with cell payloads
held as SoA ``[n_devices, rows, ...]`` torch tensors.  Under one controller
all ``n_devices`` slots live on one device, so the leading axis plays the
role of the JAX mesh axis and device-count invariance stays testable.
Under several controllers (``initialize(controllers=...)``,
``parallel/mesh.py``: one process a card or a block of slots) every
controller keeps the replicated host metadata for all slots and payload
tensors for its own block ``slots`` only; ``get_cell_data``, agreement
(builder settings, user neighbourhoods, AMR requests, pins and weights),
``remap_state``, ``balance_load``, the halo and the checkpoint writer are
collectives every controller calls in the same order.

Grid and refinement metadata stay host-side numpy, as in the JAX package.
A structural change (``stop_refining``, ``balance_load``) patches the epoch
incrementally (``parallel/epoch_delta.py``) and falls back to the full
``build_epoch``, its oracle, where the patch declines; registering or
removing a neighborhood rebuilds in full.  A patched epoch may give a leaf
another row than a full build does, so states are compared across the
packages by cell id, never by row.

Load balancing (``balance_load``, one-shot or staged through
``initialize_balance_load`` / ``continue_balance_load`` /
``finish_balance_load``, flat or hierarchical) computes new owners with the
host partitioners of ``parallel/loadbalance.py``; payloads follow with
``remap_state`` or, staged, with device-side row copies.

Ghost refresh is blocking (``update_copies_of_remote_neighbors``) or
split-phase (``start_remote_neighbor_copy_updates`` /
``wait_remote_neighbor_copy_updates``), under an optional per-cell payload
policy (``set_cell_datatype``); see ``parallel/halo.py``.

Checkpoint I/O (``save_grid_data``, ``load_grid_data``,
``start_loading_grid_data``; ``io/checkpoint.py``, the JAX package's file
format) and the VTK writer (``write_vtk_file``) read the state back with
one ``.cpu()`` a field; a loaded grid is rebuilt from the saved leaf set
with ``initialize(leaf_set=...)``, which checks the set.

Telemetry (``obs``): each grid stamps its ``grid_id`` onto the timeline
spans its entry points record; ``balance_load`` is the
``loadbalance.migrate`` phase (with ``loadbalance.migrations``,
``cells_migrated`` and the imbalance gauges), ``stop_refining`` the
``amr.refine`` phase; ``telemetry``, ``events`` and ``report()`` read the
process-wide registry and timeline.
"""
from __future__ import annotations

import itertools as _itertools
from contextlib import nullcontext as _nullcontext

import numpy as np
import torch

from .amr.refinement import AmrQueues
from .convert import torch_dtype
from .core.mapping import Mapping
from .core.neighborhood import default_neighborhood, validate_neighborhood
from .core.neighbors import InconsistentGridError, LeafSet
from .core.topology import Topology
from .geometry import CartesianGeometry, NoGeometry
from .obs.events import timeline as _timeline
from .obs.registry import metrics as _metrics
from .parallel.epoch import build_epoch
from .parallel.epoch_delta import TablePool, build_epoch_delta
from .parallel.exec_cache import ExecutableCache
from .parallel.halo import HaloExchange
from .parallel.halo_dma import AS_SIGNED
from .parallel.partition import block_partition, hilbert_partition, morton_partition
from .parallel.shapes import epoch_shape_hints, signature_of

__all__ = ["Grid", "CellSpec", "resolve_device", "HAS_NO_NEIGHBOR",
           "HAS_LOCAL_NEIGHBOR_OF", "HAS_LOCAL_NEIGHBOR_TO",
           "HAS_REMOTE_NEIGHBOR_OF", "HAS_REMOTE_NEIGHBOR_TO",
           "HAS_LOCAL_NEIGHBOR_BOTH", "HAS_REMOTE_NEIGHBOR_BOTH"]

#: field name -> (per-cell shape tuple, dtype)
CellSpec = dict

#: source of process-unique ``Grid.grid_id`` values (timeline span
#: separation for concurrent grids — see ``obs.events``)
_GRID_IDS = _itertools.count()

#: reusable no-op context (``nullcontext`` keeps no state, so one
#: instance serves every disabled-timeline dispatch)
_NULL_CTX = _nullcontext()

#: neighbor-relation criteria bits for ``Grid.get_cells_by_criteria``
#: (reference ``dccrg.hpp:85-142``)
HAS_NO_NEIGHBOR = 0
HAS_LOCAL_NEIGHBOR_OF = 1 << 0
HAS_LOCAL_NEIGHBOR_TO = 1 << 1
HAS_REMOTE_NEIGHBOR_OF = 1 << 2
HAS_REMOTE_NEIGHBOR_TO = 1 << 3
HAS_LOCAL_NEIGHBOR_BOTH = HAS_LOCAL_NEIGHBOR_OF | HAS_LOCAL_NEIGHBOR_TO
HAS_REMOTE_NEIGHBOR_BOTH = HAS_REMOTE_NEIGHBOR_OF | HAS_REMOTE_NEIGHBOR_TO


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


class Grid:
    # ------------------------------------------------------------- builder

    def __init__(self):
        self._length = (1, 1, 1)
        self._max_ref_lvl = 0
        self._periodic = (False, False, False)
        self._hood_length = 1
        self._lb_method = "RCB"
        self._geometry_factory = None
        # partitioner options: global, and per hierarchical level
        self._partitioning_options = {}
        self._hier_levels = []
        self._hier_options = []
        self._staged_lb = None
        self.initialized = False

    def set_initial_length(self, length) -> "Grid":
        self._assert_uninitialized()
        self._length = tuple(int(v) for v in length)
        return self

    def set_maximum_refinement_level(self, lvl: int) -> "Grid":
        self._assert_uninitialized()
        self._max_ref_lvl = int(lvl)
        return self

    def set_periodic(self, x: bool, y: bool, z: bool) -> "Grid":
        self._assert_uninitialized()
        self._periodic = (bool(x), bool(y), bool(z))
        return self

    def set_neighborhood_length(self, n: int) -> "Grid":
        self._assert_uninitialized()
        if n < 0:
            raise ValueError("neighborhood length must be >= 0")
        self._hood_length = int(n)
        return self

    def set_load_balancing_method(self, method: str) -> "Grid":
        self._assert_uninitialized()
        self._lb_method = str(method).upper()
        return self

    def set_geometry(self, factory=None, **params) -> "Grid":
        """``factory(mapping, topology) -> geometry``; or a geometry class
        plus keyword params (e.g. ``set_geometry(CartesianGeometry,
        start=..., level_0_cell_length=...)``)."""
        self._assert_uninitialized()
        if factory is None:
            factory = CartesianGeometry
        self._geometry_factory = lambda m, t: factory(mapping=m, topology=t, **params)
        return self

    def _assert_uninitialized(self):
        if self.initialized:
            raise RuntimeError("grid already initialized")

    # ---------------------------------------------------------- initialize

    def initialize(self, n_devices: int | None = None, device=None,
                   leaf_set=None, controllers=None) -> "Grid":
        """Create level-0 cells, stripe them over ``n_devices`` slab slots
        (default: one a controller) and build all derived state.  Payloads
        are allocated on ``device`` (default the controllers' device, else
        CUDA; ``"cpu"`` must be asked for).

        ``controllers`` (``parallel/mesh.py``; default
        ``parallel.mesh.current()``): under several controllers every
        process builds the same leaves, epoch and tables for all slots and
        holds payloads only for its own block of slots (``slots``); the
        slot count must divide by the controller count, and the builder
        settings must agree on every controller (``assert_agreement``).

        ``leaf_set``: start from an existing leaf-id array instead of the
        level-0 grid — the checkpoint loader's path (the saved set is a
        2:1 forest already, so derived state builds once instead of the
        reference's level-by-level refinement replay,
        ``dccrg.hpp:3647-3716``).  The set is checked: duplicate ids,
        invalid ids, a set that does not tile the domain exactly, a cell
        listed with its ancestor, and a set that breaks the 2:1 balance
        all raise ``ValueError``."""
        with _metrics.phase("grid.initialize"):
            return self._initialize(n_devices, device, leaf_set, controllers)

    def _initialize(self, n_devices, device, leaf_set, controllers) -> "Grid":
        """:meth:`initialize`'s body."""
        self._assert_uninitialized()
        from .parallel.mesh import current

        ctl = current() if controllers is None else controllers
        if device is None and ctl.device is not None:
            device = ctl.device
        self.device = resolve_device(device)
        self.n_devices = ctl.size if n_devices is None else int(n_devices)
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        #: the controller group (``parallel/mesh.py``) and this process's
        #: block of slots: payload tensors are ``[len(slots), R, ...]``
        self.controllers = ctl
        self.slots = ctl.local_slots(self.n_devices)
        self.mapping = Mapping(length=self._length, max_refinement_level=self._max_ref_lvl)
        self.topology = Topology(periodic=self._periodic)
        factory = self._geometry_factory or (lambda m, t: NoGeometry(m, t))
        self.geometry = factory(self.mapping, self.topology)
        self.neighborhoods = {None: default_neighborhood(self._hood_length)}
        self._ring_hints = {}
        # built cohort bodies (``serve/ensemble.py``): they survive every
        # epoch rebuild, as the JAX Grid's executable cache does
        self.exec_cache = ExecutableCache()
        self._cell_datatype = None
        self.amr = AmrQueues()
        # load-balance weights and pins (commit_adaptation hands them from
        # refined cells to their children)
        self.cell_weights = {}
        self.pin_requests = {}
        # retired epochs' gather tables, recycled by the next delta patch
        self._table_pool = TablePool()
        self._last_new_cells = np.zeros(0, dtype=np.uint64)
        self._last_removed_cells = np.zeros(0, dtype=np.uint64)
        self._last_adaptation_delta = None
        self._prev_epoch = None
        #: process-unique id stamped (as ``grid_id``) onto every timeline
        #: span this grid's instrumented seams record, so traces from
        #: concurrent grids stay separable in one merged timeline
        self.grid_id = next(_GRID_IDS)
        self._tl_ctx = None   # cached reusable timeline context frame

        if leaf_set is not None:
            cells = np.unique(np.asarray(leaf_set, dtype=np.uint64))
            if len(cells) != len(np.asarray(leaf_set)):
                raise ValueError("leaf_set contains duplicate ids")
            self._validate_leaf_tiling(cells)
        else:
            n0 = int(np.prod(self._length))
            cells = np.arange(1, n0 + 1, dtype=np.uint64)
        if ctl.multi:
            # enforced agreement on the builder inputs (the JAX package's
            # grid.py:180-190): a controller whose settings diverge would
            # build another grid and desynchronise every later collective
            from .utils.collectives import assert_agreement

            settings = repr((
                self._length, self._max_ref_lvl, self._periodic,
                self._hood_length, str(self._lb_method).upper(),
                type(self.geometry).__name__, self.n_devices,
            )).encode()
            assert_agreement(
                "Grid.initialize settings",
                settings + self.geometry.params_to_file_bytes()
                + (cells.tobytes() if leaf_set is not None else b""),
            )
        with _metrics.phase("grid.partition"):
            if self._lb_method in ("HSFC", "SFC", "HILBERT"):
                owner = hilbert_partition(self.mapping, cells, self.n_devices)
            elif self._lb_method == "MORTON":
                owner = morton_partition(self.mapping, cells, self.n_devices)
            else:
                owner = block_partition(cells, self.n_devices)
        self.leaves = LeafSet(cells=cells, owner=owner.astype(np.int32))
        self.initialized = True
        if leaf_set is None:
            self._rebuild()
            return self
        # the neighbor engine itself rejects many inconsistent sets (no
        # leaf found for a slot); surface those under the same contract
        try:
            self._rebuild()
        except InconsistentGridError as e:
            raise ValueError(
                f"leaf_set is not a consistent 2:1 forest: {e}"
            ) from e
        self._validate_two_to_one()
        return self

    def _validate_leaf_tiling(self, cells):
        """Exact-cover check for a candidate leaf set: the level-weighted
        volumes must tile the domain exactly, and no cell may be listed
        with an ancestor (the volume sum alone could be met by an overlap
        and a hole that compensate)."""
        lvl = self.mapping.get_refinement_level(cells)
        if (lvl < 0).any():
            raise ValueError("leaf_set contains invalid cell ids")
        L = self.mapping.max_refinement_level
        counts = np.bincount(lvl.astype(np.int64), minlength=L + 1)
        total = sum(int(c) << (3 * (L - k)) for k, c in enumerate(counts))
        expect = int(np.prod(self._length)) << (3 * L)
        if total != expect:
            raise ValueError(
                "leaf_set does not tile the domain (corrupt checkpoint?)"
            )
        anc = np.unique(cells[lvl > 0])
        while len(anc):
            anc = np.unique(self.mapping.get_parent(anc))
            if np.isin(anc, cells).any():
                raise ValueError(
                    "leaf_set contains both a cell and its ancestor "
                    "(corrupt checkpoint?)"
                )
            anc = anc[self.mapping.get_refinement_level(anc) > 0]

    def _validate_two_to_one(self):
        """Every neighbor pair's refinement levels differ by at most one
        (the invariant the neighbor engine assumes), read from the epoch's
        neighbor tables."""
        hood = self.epoch.hoods[None]
        clen = self.epoch.cell_len.astype(np.int64)[..., None]
        nlen = hood.nbr_len.astype(np.int64)
        bad = hood.nbr_valid & ((nlen > 2 * clen) | (clen > 2 * nlen))
        if bad.any():
            raise ValueError(
                "leaf_set violates 2:1 balance (corrupt checkpoint?)"
            )

    def _uniform_geometry(self) -> bool:
        """Whether every level-0 cell shares one physical size — the
        precondition for the dense and flat fast paths' metric factors."""
        return bool(getattr(self.geometry, "uniform_level0", False))

    def shape_signature(self):
        """The current epoch's shape signature (see ``parallel/shapes.py``)."""
        return signature_of(self.epoch, self._ring_hints)

    def _rebuild(self):
        """Recompute every derived structure for the current leaf set (the
        reference's post-mutation rebuild tail, ``dccrg.hpp:4063-4111``)."""
        self.epoch = build_epoch(
            self.mapping, self.topology, self.leaves, self.n_devices,
            self.neighborhoods,
            uniform_geometry=self._uniform_geometry(),
            shape_hints=epoch_shape_hints(getattr(self, "epoch", None)),
        )
        self._halo_cache = {}
        self._unrefine_cache = None

    def _rebuild_incremental(self, old_epoch):
        """Derive the epoch of the current (already changed) leaf set by
        patching ``old_epoch`` (``parallel/epoch_delta.py``), or rebuild in
        full where the patch declines; the old epoch's shapes are the
        hints either way."""
        epoch = build_epoch_delta(
            old_epoch, self.leaves, self.n_devices, self.neighborhoods,
            uniform_geometry=self._uniform_geometry(),
            shape_hints=epoch_shape_hints(old_epoch),
            table_pool=self._table_pool,
        )
        if epoch is None:
            self._rebuild()
            return
        self.epoch = epoch
        self._halo_cache = {}
        self._unrefine_cache = None

    def _harvest_tables(self, old_epoch) -> None:
        """Park a retired epoch's gather tables for reuse by the next delta
        patch, unless another grid shares the epoch (``copy_structure``).
        The JAX package stops recycling under several controllers
        (``grid.py:292-297``: its jitted code embeds the host tables
        themselves); the port copies every table to its device, so
        recycling stays safe there too."""
        if getattr(old_epoch, "_shared", False):
            return
        for h in old_epoch.hoods.values():
            self._table_pool.put(
                (h.nbr_rows, h.nbr_valid, h.nbr_offset, h.nbr_len, h.nbr_slot)
            )
        old_epoch.hoods = {}

    # ---------------------------------------------------------- cell views

    def _assert_initialized(self):
        if not self.initialized:
            raise RuntimeError("grid not initialized")

    def _assert_no_staged_lb(self):
        """Structural mutators are refused while a staged balance_load is
        pending: the staged epoch reflects the current leaf set."""
        if self._staged_lb is not None:
            raise RuntimeError("a staged balance_load is in progress")

    def get_cells(self) -> np.ndarray:
        """All existing (leaf) cells, ascending id — global view."""
        self._assert_initialized()
        return self.leaves.cells.copy()

    def local_cells(self, device: int | None = None) -> np.ndarray:
        """Cells owned by a device slot (all slots if None), ascending id."""
        self._assert_initialized()
        if device is None:
            return self.leaves.cells.copy()
        return self.leaves.cells[self.epoch.local_pos[device]]

    def inner_cells(self, device: int, hood_id=None) -> np.ndarray:
        """A slot's cells with no remote neighbor in the neighborhood."""
        rows = np.flatnonzero(self.epoch.hoods[hood_id].inner_mask[device])
        return self.epoch.cell_ids[device, rows]

    def outer_cells(self, device: int, hood_id=None) -> np.ndarray:
        """A slot's cells with a remote neighbor (of or to) in the
        neighborhood."""
        rows = np.flatnonzero(self.epoch.hoods[hood_id].outer_mask[device])
        return self.epoch.cell_ids[device, rows]

    def remote_cells(self, device: int) -> np.ndarray:
        """Ghost cells held by a device slot."""
        return self.leaves.cells[self.epoch.ghost_pos[device]]

    def get_owner(self, ids) -> np.ndarray:
        """Owning slot of given cells (-1 if not a leaf): the cell
        directory query (reference ``cell_process``)."""
        pos = self.leaves.position(ids)
        return np.where(pos >= 0, self.leaves.owner[np.maximum(pos, 0)], -1)

    def is_local(self, ids, device: int) -> np.ndarray:
        return self.get_owner(ids) == device

    def get_neighbors_of(self, cell, hood_id=None):
        """(ids, offsets) of a cell's neighbors in reference order."""
        self._assert_initialized()
        pos = int(self.leaves.position(np.uint64(cell)))
        if pos < 0:
            raise ValueError(f"cell {cell} does not exist")
        return self.epoch.hoods[hood_id].lists.row(pos)

    def get_neighbors_to(self, cell, hood_id=None) -> np.ndarray:
        """Unique ids of cells having given cell as neighbor."""
        self._assert_initialized()
        pos = int(self.leaves.position(np.uint64(cell)))
        if pos < 0:
            raise ValueError(f"cell {cell} does not exist")
        h = self.epoch.hoods[hood_id]
        return self.leaves.cells[h.to_src[h.to_start[pos] : h.to_start[pos + 1]]]

    def get_face_neighbors_of(self, cell):
        """(neighbor id, direction) pairs with directions +-1/+-2/+-3 as in
        the reference (``dccrg.hpp:2806-2933``): neighbors sharing a face,
        direction is the axis (1=x, 2=y, 3=z) signed by side."""
        ids, offs = self.get_neighbors_of(cell)
        own_len = int(self.mapping.get_cell_length_in_indices(np.uint64(cell)))
        nbr_len = self.mapping.get_cell_length_in_indices(ids).astype(np.int64)
        out = []
        seen = set()
        for nid, off, nl in zip(ids, offs, nbr_len):
            d = _face_direction(off, own_len, int(nl))
            if d != 0 and (int(nid), d) not in seen:
                seen.add((int(nid), d))
                out.append((np.uint64(nid), d))
        return out

    def get_refinement_level(self, cell) -> int:
        return int(self.mapping.get_refinement_level(np.uint64(cell)))

    def neighbor_criteria(self, device: int, hood_id=None) -> np.ndarray:
        """Bitmask of neighbor-relation criteria per local cell of a slot
        (reference bits, ``dccrg.hpp:85-142``)."""
        h = self.epoch.hoods[hood_id]
        lists = h.lists
        owner = self.leaves.owner.astype(np.int64)
        N = len(self.leaves)
        src = np.repeat(np.arange(N), np.diff(lists.start))
        bits = np.zeros(N, dtype=np.int32)
        local_nbr = owner[lists.nbr_pos] == owner[src]
        np.bitwise_or.at(bits, src[local_nbr], HAS_LOCAL_NEIGHBOR_OF)
        np.bitwise_or.at(bits, src[~local_nbr], HAS_REMOTE_NEIGHBOR_OF)
        src_to = np.repeat(np.arange(N), np.diff(h.to_start))
        local_to = owner[h.to_src] == owner[src_to]
        np.bitwise_or.at(bits, src_to[local_to], HAS_LOCAL_NEIGHBOR_TO)
        np.bitwise_or.at(bits, src_to[~local_to], HAS_REMOTE_NEIGHBOR_TO)
        return bits[self.epoch.local_pos[device]]

    def get_cells_by_criteria(
        self, device: int, criteria: int, exact_match: bool = False, hood_id=None
    ) -> np.ndarray:
        """Local cells of a slot filtered by neighbor-relation criteria bits
        (reference ``get_cells``, ``dccrg.hpp:651-741, 2946-3053``): any-bit
        match by default, all-and-only with ``exact_match``."""
        bits = self.neighbor_criteria(device, hood_id)
        cells = self.local_cells(device)
        if criteria == HAS_NO_NEIGHBOR:
            return cells[bits == 0]
        if exact_match:
            return cells[bits == criteria]
        return cells[(bits & criteria) != 0]

    # ------------------------------------------------ structure sharing

    def copy_structure(self) -> "Grid":
        """A new Grid sharing this grid's decomposition (mapping, topology,
        geometry, leaf set, epoch, device) but no payload: the reference's
        cross-instantiation copy constructor (``dccrg.hpp:338-438``).  The
        two share the epoch until either changes structure."""
        g = Grid.__new__(Grid)
        g.__dict__.update(self.__dict__)
        g.cell_weights = dict(self.cell_weights)
        g.pin_requests = dict(self.pin_requests)
        g._hier_levels = list(self._hier_levels)
        g._hier_options = [dict(o) for o in self._hier_options]
        g._partitioning_options = dict(self._partitioning_options)
        g.neighborhoods = dict(self.neighborhoods)
        g.amr = AmrQueues()
        g._halo_cache = dict(self._halo_cache)
        g._table_pool = TablePool()
        # the shared epoch's tables must never be recycled into either
        # grid's pool while the other may still read them
        if hasattr(self, "epoch"):
            self.epoch._shared = True
        return g

    # -------------------------------------------------- options / getters

    def set_partitioning_option(self, name: str, value) -> "Grid":
        """Record a partitioner option (the reference forwards these as
        Zoltan strings, ``dccrg.hpp:5537-5564``): ``LB_METHOD``,
        ``IMBALANCE_TOL`` and ``PHG_CUT_OBJECTIVE`` act, known Zoltan
        tuning knobs are inert, anything else warns
        (``parallel/loadbalance.py``); reserved names raise."""
        self._check_reserved_option(name)
        self._partitioning_options[str(name)] = value
        return self

    @staticmethod
    def _check_reserved_option(name):
        from .parallel.loadbalance import RESERVED_OPTIONS, warn_unknown_option

        if str(name).upper() in RESERVED_OPTIONS:
            raise ValueError(f"option {name!r} is reserved for dccrg")
        warn_unknown_option(name)

    def get_partitioning_options(self, level: int | None = None) -> dict:
        """The recorded global options, or with ``level`` that hierarchical
        level's own ({} for a level that does not exist)."""
        if level is None:
            return dict(self._partitioning_options)
        if not 0 <= int(level) < len(self._hier_options):
            return {}
        return dict(self._hier_options[int(level)])

    def get_maximum_refinement_level(self) -> int:
        return self.mapping.max_refinement_level

    def get_neighborhood_length(self) -> int:
        return self._hood_length

    def get_load_balancing_method(self) -> str:
        return self._lb_method

    def get_periodicity(self) -> tuple:
        return self.topology.periodic

    def get_total_cells(self) -> int:
        return len(self.leaves)

    def get_local_cell_count(self, device: int) -> int:
        return int(self.epoch.n_local[device])

    def get_ghost_cell_count(self, device: int) -> int:
        return int(self.epoch.n_ghost[device])

    @property
    def length(self):
        return self.mapping.length

    def get_number_of_update_send_cells(self, device: int, hood_id=None) -> int:
        return int(self.epoch.hoods[hood_id].pair_counts[device].sum())

    def get_number_of_update_receive_cells(self, device: int, hood_id=None) -> int:
        return int(self.epoch.hoods[hood_id].pair_counts[:, device].sum())

    # ------------------------------------------------------------ payloads

    def new_state(self, spec: CellSpec, fill=0):
        """Allocate SoA payload tensors ``[D, R, *shape]``, one per field
        (``[len(slots), R, *shape]``, this controller's slots, under several
        controllers)."""
        self._assert_initialized()
        D, R = len(self.slots), self.epoch.R
        return {
            name: torch.full((D, R) + tuple(shape), fill,
                             dtype=torch_dtype(dtype), device=self.device)
            for name, (shape, dtype) in spec.items()
        }

    def _mine(self, dev):
        """Which of the slots ``dev`` are this controller's, and their
        local indices."""
        lo, hi = self.slots.start, self.slots.stop
        mine = (dev >= lo) & (dev < hi)
        return mine, dev[mine] - lo

    def slot_view(self, a):
        """This controller's block ``a[slots]`` of a per-slot host table
        ``[D, ...]`` (``a`` itself under one controller)."""
        if not self.controllers.multi:
            return a
        return a[self.slots.start:self.slots.stop]

    def _owner_rows(self, ids, what: str):
        ids = np.asarray(ids, dtype=np.uint64)
        pos = self.leaves.position(ids)
        if (pos < 0).any():
            raise ValueError(f"{what}: non-existing cell")
        return self.epoch.global_rows(pos)

    def set_cell_data(self, state, field: str, ids, values):
        """Host-side scatter of per-cell values into a field (the init and
        I/O path, not the compute path); returns a new state."""
        dev, row = self._owner_rows(ids, "set_cell_data")
        host = state[field].cpu().numpy().copy()
        if self.controllers.multi:
            # every controller is given every value; it keeps its slots'
            mine, ldev = self._mine(dev)
            vals = np.broadcast_to(np.asarray(values, dtype=host.dtype),
                                   (len(dev),) + host.shape[2:])
            host[ldev, row[mine]] = vals[mine]
        else:
            host[dev, row] = values
        return {**state, field: torch.from_numpy(host).to(state[field].device)}

    def get_cell_data(self, state, field: str, ids):
        """Host-side gather of per-cell values (verification/I/O path); a
        collective under several controllers (``collectives.fetch``)."""
        from .utils.collectives import fetch

        dev, row = self._owner_rows(ids, "get_cell_data")
        return fetch(state[field])[dev, row]

    def state_from_host(self, spec: CellSpec, ids, values: dict, fill=0):
        """A new state whose fields hold ``values[name]`` (host arrays, one
        row per id) at ``ids``' owner rows and ``fill`` elsewhere, built on
        the host and moved to the device once a field."""
        self._assert_initialized()
        dev, row = self._owner_rows(ids, "state_from_host")
        D, R = len(self.slots), self.epoch.R
        mine, ldev = self._mine(dev)
        state = {}
        for name, (shape, dtype) in spec.items():
            host = np.full((D, R) + tuple(shape), fill, dtype=np.dtype(dtype))
            if name in values:
                if self.controllers.multi:
                    host[ldev, row[mine]] = np.asarray(values[name])[mine]
                else:
                    host[dev, row] = values[name]
            state[name] = torch.from_numpy(host).to(self.device)
        return state

    # ---------------------------------------------------------------- halo

    def set_cell_datatype(self, cell_datatype) -> "Grid":
        """Per-cell dynamic payload policy — the reference's
        ``get_mpi_datatype(cell_id, sender, receiver, receiving,
        neighborhood_id)`` seam (``dccrg_get_cell_datatype.hpp:48-125``).
        ``cell_datatype(field, cell_ids, sender, receiver, hood_id) -> bool
        mask`` selects which of a pair's cells transfer ``field``; unselected
        ghost copies keep their previous values.  Evaluated once per epoch
        and again after every rebuild.  ``None`` clears the policy."""
        self._assert_initialized()
        self._cell_datatype = cell_datatype
        self._halo_cache = {}
        return self

    def halo(self, hood_id=None, cell_datatype=...) -> HaloExchange:
        """The exchange schedule of a neighborhood (cached per epoch).
        ``cell_datatype`` overrides the grid-level policy for this schedule
        (``...`` = inherit, None = full payloads)."""
        self._assert_initialized()
        installed = self._cell_datatype
        policy = installed if cell_datatype is ... else cell_datatype

        def build():
            return HaloExchange(
                self.epoch, self.epoch.hoods[hood_id], self.device,
                cell_datatype=policy, hood_id=hood_id,
                ring_hints=self._ring_hints, controllers=self.controllers,
            )

        # only the installed policy and the no-policy schedule are cached: an
        # ad-hoc override (often a fresh closure a call) gets a fresh,
        # caller-owned schedule instead of growing the cache
        if policy is not None and policy is not installed:
            return build()
        key = (hood_id, policy)
        if key not in self._halo_cache:
            self._halo_cache[key] = build()
        return self._halo_cache[key]

    def _span_ctx(self):
        """Timeline context for this grid's instrumented entry points:
        every span recorded inside (halo dispatches, rebuild phases...)
        carries ``grid_id`` — workloads layer ``timeline.context(step=i)``
        on top — so merged traces from concurrent grids stay separable
        (see ``obs.events.EventTimeline.context``).  The frame object is
        cached: the per-dispatch cost is an enabled check plus a list
        push/pop."""
        if not _timeline.enabled:
            return _NULL_CTX
        ctx = self._tl_ctx
        if ctx is None:
            ctx = self._tl_ctx = _timeline.context(grid_id=self.grid_id)
        return ctx

    def update_copies_of_remote_neighbors(self, state, hood_id=None):
        """Blocking ghost refresh (reference ``dccrg.hpp:966-1000``)."""
        with self._span_ctx():
            return self.halo(hood_id)(state)

    def start_remote_neighbor_copy_updates(self, state, hood_id=None):
        """Split-phase start (reference ``dccrg.hpp:5010-5105``): gather the
        ghost payloads (on CUDA, on a side stream) and return a
        ``HaloHandle``; the state is untouched, so work on inner cells can
        be queued before ``wait_remote_neighbor_copy_updates(state,
        handle)`` merges the payloads."""
        with self._span_ctx():
            return self.halo(hood_id).start(state)

    def wait_remote_neighbor_copy_updates(self, state, handle=None, hood_id=None):
        """Split-phase wait: merge the ``start`` handle's payloads into the
        ghost rows.  Without a handle this is a blocking ghost refresh."""
        with self._span_ctx():
            if handle is None:
                return self.halo(hood_id)(state)
            return self.halo(hood_id).finish(state, handle)

    # ------------------------------------------------------------------ AMR

    def _leaf_level(self, cell) -> int:
        pos = int(self.leaves.position(np.uint64(cell)))
        if pos < 0:
            return -1
        return self.mapping.refinement_level_of(int(cell))

    def refine_completely(self, cell) -> bool:
        """Queue a cell for refinement into 8 children at the next
        ``stop_refining`` (reference ``dccrg.hpp:2434-2532``)."""
        cell = int(cell)
        lvl = self._leaf_level(cell)
        if lvl < 0:
            return False
        if lvl == self.mapping.max_refinement_level:
            self.dont_unrefine(cell)
            return True
        if cell in self.amr.not_to_refine:
            return False
        ids = None
        if self.amr.not_to_refine:
            ids, _ = self.get_neighbors_of(cell)
            n_lvl = self.mapping.get_refinement_level(ids)
            if any(
                int(n) in self.amr.not_to_refine
                for n in ids[n_lvl < lvl]
            ):
                return False
        self.amr.to_refine.add(cell)
        # cancel conflicting unrefines: own siblings + same-or-coarser
        # neighbors' siblings (skipped when no unrefines are pending)
        if self.amr.to_unrefine:
            if ids is None:
                ids, _ = self.get_neighbors_of(cell)
            both = np.concatenate(
                [[np.uint64(cell)], ids, self.get_neighbors_to(cell)]
            ).astype(np.uint64)
            nl = self.mapping.get_refinement_level(both)
            cand = both[nl <= lvl]
            sibs = self.mapping.get_siblings(cand).reshape(-1)
            self.amr.to_unrefine.difference_update(sibs.tolist())
        return True

    def unrefine_completely(self, cell) -> bool:
        """Queue a cell's sibling family for replacement by its parent
        (reference ``dccrg.hpp:2560-2655``)."""
        cell = int(cell)
        lvl = self._leaf_level(cell)
        if lvl < 0:
            return False
        if lvl == 0:
            return True
        # per-sibling checks in the reference's order: has-children first
        # (False), then refine-queued/vetoed (True)
        siblings = self.mapping.siblings_of(cell)
        is_leaf = self.leaves.exists(np.asarray(siblings, dtype=np.uint64))
        for sib, leaf in zip(siblings, is_leaf):
            if not leaf:
                return False
            if sib in self.amr.to_refine or sib in self.amr.not_to_unrefine:
                return True
        if not self.amr.to_unrefine.isdisjoint(siblings):
            return True
        # the parent's would-be neighborhood must not hold too-fine cells
        too_fine, same_lvl_nbrs = self._unrefine_parent_info(
            self.mapping.parent_of(cell)
        )
        if too_fine:
            return True  # no-op: neighbor more than one level finer
        if not self.amr.to_refine.isdisjoint(same_lvl_nbrs):
            return True  # a would-be same-size neighbor is being refined
        self.amr.to_unrefine.add(cell)
        return True

    def _build_unrefine_cache(self):
        """Per-epoch answers for the unrefine parent-hood checks: one
        neighbor search over every candidate parent.  Returns ``(epoch,
        parents(sorted), too_fine_all, fcells, fstart)``."""
        cache = self._unrefine_cache
        if cache is not None and cache[0] is self.epoch:
            return cache
        from .amr.refinement import _find_for_nonleaves

        lvl = self.mapping.get_refinement_level(self.leaves.cells)
        finer = self.leaves.cells[lvl > 0]
        parents = np.unique(self.mapping.get_parent(finer))
        if len(parents):
            plists = _find_for_nonleaves(
                self.mapping, self.topology, self.leaves,
                parents, self.neighborhoods[None],
            )
            p_lvl = self.mapping.get_refinement_level(parents)
            counts = np.diff(plists.start)
            src = np.repeat(np.arange(len(parents)), counts)
            pos = plists.nbr_pos
            neg = (pos < 0).astype(np.int64)
            cum = np.concatenate(([0], np.cumsum(neg)))
            too_fine_all = (
                cum[plists.start[1:]] - cum[plists.start[:-1]]
            ) > 0
            n_lvl = np.where(
                pos >= 0,
                self.mapping.get_refinement_level(
                    self.leaves.cells[np.maximum(pos, 0)]
                ),
                -1,
            )
            fine_mask = n_lvl == p_lvl[src] + 1
            fsrc = src[fine_mask]
            fcells = self.leaves.cells[pos[fine_mask]]
            fcounts = np.bincount(fsrc, minlength=len(parents))
            fstart = np.concatenate(([0], np.cumsum(fcounts)))
        else:
            too_fine_all = np.zeros(0, dtype=bool)
            fcells = np.zeros(0, dtype=np.uint64)
            fstart = np.zeros(1, dtype=np.int64)
        cache = (self.epoch, parents, too_fine_all, fcells, fstart)
        self._unrefine_cache = cache
        return cache

    def _unrefine_parent_info(self, parent: int):
        """(too_fine, ids of the parent's would-be neighbors one level
        finer than it) for a candidate parent, from the per-epoch cache."""
        _, parents, too_fine_all, fcells, fstart = (
            self._build_unrefine_cache()
        )
        i = int(np.searchsorted(parents, np.uint64(parent)))
        if i >= len(parents) or parents[i] != np.uint64(parent):
            return True, frozenset()
        return (
            bool(too_fine_all[i]),
            set(fcells[fstart[i]:fstart[i + 1]].tolist()),
        )

    def dont_refine(self, cell) -> bool:
        cell = int(cell)
        lvl = self._leaf_level(cell)
        if lvl < 0:
            return False
        if lvl == self.mapping.max_refinement_level:
            return True
        self.amr.to_refine.discard(cell)
        self.amr.not_to_refine.add(cell)
        return True

    def dont_unrefine(self, cell) -> bool:
        cell = int(cell)
        lvl = self._leaf_level(cell)
        if lvl < 0:
            return False
        if lvl == 0:
            return True
        siblings = self.mapping.siblings_of(cell)
        if any(s in self.amr.not_to_unrefine for s in siblings):
            return True
        for s in siblings:
            self.amr.to_unrefine.discard(s)
        self.amr.not_to_unrefine.add(cell)
        return True

    # ------------------------------------------------- bulk request storms

    @staticmethod
    def _set_array(s):
        return np.fromiter(s, dtype=np.uint64, count=len(s))

    def refine_completely_many(self, cells) -> np.ndarray:
        """Vectorized ``refine_completely`` over an id array: the same final
        queues and per-cell returns as the scalar calls in order.  The
        vectorized form engages when no unrefines are pending and no
        refine vetoes exist; otherwise it runs the scalar loop."""
        ids = np.asarray(cells, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            return np.zeros(0, dtype=bool)
        if self.amr.not_to_refine or self.amr.to_unrefine:
            return np.array(
                [self.refine_completely(int(c)) for c in ids], dtype=bool
            )
        pos = self.leaves.position(ids)
        exists = pos >= 0
        lvl = self.mapping.get_refinement_level(ids)
        at_max = exists & (lvl == self.mapping.max_refinement_level)
        if at_max.any():
            self.dont_unrefine_many(ids[at_max])
        mid = exists & ~at_max
        self.amr.to_refine.update(int(c) for c in ids[mid])
        return exists

    def unrefine_completely_many(self, cells) -> np.ndarray:
        """Vectorized ``unrefine_completely`` over an id array: the same
        final queues and returns as the scalar loop."""
        ids = np.asarray(cells, dtype=np.uint64).reshape(-1)
        out = np.zeros(len(ids), dtype=bool)
        if len(ids) == 0:
            return out
        pos = self.leaves.position(ids)
        exists = pos >= 0
        lvl = np.where(exists, self.mapping.get_refinement_level(ids), 0)
        out[exists & (lvl == 0)] = True
        idx = np.flatnonzero(exists & (lvl > 0))
        if not len(idx):
            return out
        sibs = self.mapping.get_siblings(ids[idx]).reshape(len(idx), 8)
        sib_leaf = self.leaves.exists(sibs.reshape(-1)).reshape(-1, 8)
        tr_arr = (self._set_array(self.amr.to_refine)
                  if self.amr.to_refine else None)
        # the scalar loop walks siblings in order: the first non-leaf
        # sibling returns False, but a refine-queued/vetoed sibling
        # earlier in the family returns True first
        queued = np.zeros_like(sib_leaf)
        if tr_arr is not None:
            queued |= np.isin(sibs, tr_arr)
        if self.amr.not_to_unrefine:
            queued |= np.isin(
                sibs, self._set_array(self.amr.not_to_unrefine)
            )
        nonleaf = ~sib_leaf
        first_nonleaf = np.where(
            nonleaf.any(axis=1), np.argmax(nonleaf, axis=1), 8
        )
        first_queued = np.where(
            queued.any(axis=1), np.argmax(queued, axis=1), 8
        )
        ret_false = (first_nonleaf < 8) & ~(first_queued < first_nonleaf)
        out[idx] = ~ret_false
        proceed = (first_nonleaf == 8) & (first_queued == 8)
        idx = idx[proceed]
        if not len(idx):
            return out
        parents = self.mapping.get_parent(ids[idx])
        if self.amr.to_unrefine:
            tu = self._set_array(self.amr.to_unrefine)
            queued_parents = np.unique(self.mapping.get_parent(tu))
            fresh = ~np.isin(parents, queued_parents)
            idx, parents = idx[fresh], parents[fresh]
            if not len(idx):
                return out
        too_fine, has_refining = self._unrefine_parent_info_many(
            parents, tr_arr
        )
        qual = ~too_fine & ~has_refining
        idx, parents = idx[qual], parents[qual]
        if len(idx):
            # first-requested sibling per family wins
            _u, first = np.unique(parents, return_index=True)
            self.amr.to_unrefine.update(
                int(c) for c in ids[idx[np.sort(first)]]
            )
        return out

    def dont_unrefine_many(self, cells) -> np.ndarray:
        """Vectorized ``dont_unrefine``; engages when no unrefines are
        pending, else the scalar loop."""
        ids = np.asarray(cells, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            return np.zeros(0, dtype=bool)
        if self.amr.to_unrefine:
            return np.array(
                [self.dont_unrefine(int(c)) for c in ids], dtype=bool
            )
        pos = self.leaves.position(ids)
        exists = pos >= 0
        lvl = np.where(exists, self.mapping.get_refinement_level(ids), 0)
        idx = np.flatnonzero(exists & (lvl > 0))
        if len(idx):
            parents = self.mapping.get_parent(ids[idx])
            if self.amr.not_to_unrefine:
                ntu = self._set_array(self.amr.not_to_unrefine)
                vetoed_parents = np.unique(self.mapping.get_parent(ntu))
                fresh = ~np.isin(parents, vetoed_parents)
                idx, parents = idx[fresh], parents[fresh]
            if len(idx):
                _u, first = np.unique(parents, return_index=True)
                self.amr.not_to_unrefine.update(
                    int(c) for c in ids[idx[np.sort(first)]]
                )
        return exists

    def dont_refine_many(self, cells) -> np.ndarray:
        """Vectorized ``dont_refine`` (always exact: discard + add)."""
        ids = np.asarray(cells, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            return np.zeros(0, dtype=bool)
        pos = self.leaves.position(ids)
        exists = pos >= 0
        lvl = self.mapping.get_refinement_level(ids)
        mid = exists & (lvl < self.mapping.max_refinement_level)
        mids = [int(c) for c in ids[mid]]
        self.amr.to_refine.difference_update(mids)
        self.amr.not_to_refine.update(mids)
        return exists

    def _unrefine_parent_info_many(self, parents, tr_arr=None):
        """Vectorized ``_unrefine_parent_info``: (too_fine,
        same-level-neighbor-being-refined) per parent."""
        _, cp, too_fine_all, fcells, fstart = self._build_unrefine_cache()
        i = np.searchsorted(cp, parents)
        ic = np.minimum(i, max(len(cp) - 1, 0))
        found = (i < len(cp)) & (len(cp) > 0)
        if len(cp):
            found &= cp[ic] == parents
        too_fine = np.where(found, too_fine_all[ic] if len(cp) else True,
                            True)
        if tr_arr is None and self.amr.to_refine:
            tr_arr = self._set_array(self.amr.to_refine)
        if tr_arr is not None and len(tr_arr) and len(fcells):
            hit = np.isin(fcells, tr_arr).astype(np.int64)
            csum = np.concatenate(([0], np.cumsum(hit)))
            seg = (csum[fstart[1:]] - csum[fstart[:-1]]) > 0
            has_ref = np.where(found, seg[ic] if len(cp) else False, False)
        else:
            has_ref = np.zeros(len(parents), dtype=bool)
        return too_fine, has_ref

    def refine_completely_at(self, coords) -> bool:
        c = self._cell_at(coords)
        return bool(c) and self.refine_completely(c)

    def unrefine_completely_at(self, coords) -> bool:
        c = self._cell_at(coords)
        return bool(c) and self.unrefine_completely(c)

    def dont_refine_at(self, coords) -> bool:
        c = self._cell_at(coords)
        return bool(c) and self.dont_refine(c)

    def dont_unrefine_at(self, coords) -> bool:
        c = self._cell_at(coords)
        return bool(c) and self.dont_unrefine(c)

    def _cell_at(self, coords) -> int:
        for lvl in range(self.mapping.max_refinement_level, -1, -1):
            c = self.geometry.get_cell(lvl, np.asarray(coords, dtype=np.float64))
            if int(c) and bool(self.leaves.exists(np.uint64(c))):
                return int(c)
        return 0

    def get_existing_cell(self, coords) -> np.ndarray:
        """Existing leaf containing each coordinate (vectorized; 0 for
        outside) — reference ``get_existing_cell`` (``dccrg.hpp:6316``)."""
        coords = np.atleast_2d(np.asarray(coords, dtype=np.float64))
        out = np.zeros(len(coords), dtype=np.uint64)
        unresolved = np.ones(len(coords), dtype=bool)
        for lvl in range(self.mapping.max_refinement_level, -1, -1):
            if not unresolved.any():
                break
            ids = self.geometry.get_cell(lvl, coords[unresolved])
            exists = self.leaves.exists(ids)
            idx = np.flatnonzero(unresolved)
            out[idx[exists]] = ids[exists]
            unresolved[idx[exists]] = False
        return out

    def stop_refining(self, presynced: bool = False) -> np.ndarray:
        """Commit all queued refines/unrefines (veto -> induce -> override
        -> execute, reference ``dccrg.hpp:3461-3485``) and rebuild the
        epoch; returns the new cells.  States allocated before this call
        are carried over with ``remap_state``.  Under several controllers
        every controller commits the union of all controllers' queues
        (``sync_adaptation``); ``presynced`` skips the union for a caller
        that already ran it."""
        with _metrics.phase("grid.stop_refining"):
            return self._stop_refining(presynced)

    def _stop_refining(self, presynced: bool) -> np.ndarray:
        """:meth:`stop_refining`'s body."""
        self._assert_no_staged_lb()
        self._assert_initialized()
        from .amr.refinement import commit_adaptation
        from .utils.collectives import sync_adaptation

        with self._span_ctx(), _metrics.phase("amr.refine"):
            if not presynced:
                sync_adaptation(self.amr)
            old_epoch = self.epoch
            new_cells, removed, delta = commit_adaptation(self)
            self._last_new_cells = new_cells
            self._last_removed_cells = removed
            self._last_adaptation_delta = delta
            if not len(new_cells) and not len(removed):
                # nothing changed: keep the current epoch
                self._prev_epoch = None
                return new_cells.copy()
            self._rebuild_incremental(old_epoch)
            self._prev_epoch = _EpochCarry(old_epoch)
            self._harvest_tables(old_epoch)
        return new_cells.copy()

    def get_removed_cells(self) -> np.ndarray:
        """Cells removed by the last ``stop_refining`` (their parents are
        now leaves) — reference ``dccrg.hpp:3488-3520``."""
        return self._last_removed_cells.copy()

    def get_last_adaptation_delta(self):
        """The complete touched set of the last commit
        (``amr.refinement.AdaptationDelta``); None before the first."""
        return self._last_adaptation_delta

    def release_prev_epoch(self) -> None:
        """Drop the retained pre-change carry without remapping a payload;
        ``remap_state`` is the identity until the next change."""
        self._prev_epoch = None

    def remap_state(self, state, policy=None):
        """Carry a payload state across the last structural change.

        Surviving cells keep their values.  Per-field ``policy`` entries
        control the rest: ``refine`` — how children get values from their
        refined parent ("inherit" default, or "zero"); ``unrefine`` — how a
        new parent reduces its removed children ("mean" default, "sum", or
        "zero") — the array form of the reference's parent/child data
        handling after stop_refining (tests/advection/adapter.hpp:230-292).
        Runs on the host, like the JAX package's.  Under several
        controllers each controller fills its own slots: the old rows its
        new cells read from another controller's slots come over the
        transport (``_remap_sources``), the rest from its own."""
        if self._prev_epoch is None or self._prev_epoch is self.epoch:
            return state
        old, new = self._prev_epoch, self.epoch
        policy = policy or {}
        out = {}
        new_cells = new.leaves.cells
        multi = self.controllers.multi

        # classification of new leaves
        surv_pos_new = np.flatnonzero(old.leaves.exists(new_cells))
        fresh_pos_new = np.flatnonzero(~old.leaves.exists(new_cells))
        fresh = new_cells[fresh_pos_new]
        fresh_lvl = self.mapping.get_refinement_level(fresh)
        parents_of_fresh = self.mapping.get_parent(fresh)
        # children created by refinement: their parent was an old leaf
        is_child = old.leaves.exists(parents_of_fresh) & (fresh_lvl > 0)
        # new parents from unrefinement: their children were old leaves
        first_child = self.mapping.get_all_children(fresh)[:, 0]
        is_parent = np.where(
            fresh_lvl < self.mapping.max_refinement_level,
            old.leaves.exists(first_child),
            False,
        ) & ~is_child

        def per_cell(arr):
            return arr.dim() >= 2 and tuple(arr.shape[:2]) == (
                len(self.slots), old.R)

        sources = None
        if multi:
            fields = {n: a for n, a in state.items() if per_cell(a)}
            sources = self._remap_sources(
                old, new, fields, surv_pos_new, fresh_pos_new[is_child],
                parents_of_fresh[is_child], fresh[is_parent])

        for name, arr in state.items():
            if not per_cell(arr):
                # not a per-cell [D, R, ...] payload: carried unchanged
                out[name] = arr
                continue
            host_old = sources[name] if multi else arr.cpu().numpy()
            field_shape = host_old.shape[2:]
            host_new = np.zeros((new.n_devices, new.R) + field_shape, host_old.dtype)
            pol = policy.get(name, {})

            def read(ids):
                pos = old.leaves.position(ids)
                return host_old[old.leaves.owner[pos], old.row_of[pos]]

            def write(ids, values):
                pos = new.leaves.position(ids)
                host_new[new.leaves.owner[pos], new.row_of[pos]] = values

            surv = new_cells[surv_pos_new]
            write(surv, read(surv))

            children = fresh[is_child]
            if len(children):
                if pol.get("refine", "inherit") == "inherit":
                    write(children, read(parents_of_fresh[is_child]))

            parents = fresh[is_parent]
            if len(parents):
                how = pol.get("unrefine", "mean")
                if how in ("mean", "sum"):
                    fam = self.mapping.get_all_children(parents)  # (M, 8)
                    vals = read(fam.reshape(-1)).reshape((len(parents), 8) + field_shape)
                    red = vals.sum(axis=1)
                    if how == "mean":
                        red = red / 8 if np.issubdtype(red.dtype, np.floating) else red // 8
                    write(parents, red.astype(host_old.dtype))

            out[name] = torch.from_numpy(
                np.ascontiguousarray(self.slot_view(host_new))).to(arr.device)
        return out

    def _remap_sources(self, old, new, fields, surv_pos_new, child_pos_new,
                       child_parents, new_parents) -> dict:
        """Under several controllers: each field of ``fields`` (local
        ``[len(slots), R_old, ...]`` tensors) as a host ``[D, R_old, ...]``
        array holding this controller's old rows and every old row its new
        cells read from other controllers (the survivors' own rows, the
        refined parents', the unrefined children's), received over the
        host transport; other rows are 0.  Every controller derives the
        same (sender, receiver, old cell) lists from the replicated
        directories, so each message meets its receive."""
        from .parallel.transport import Transport

        ctl, lo = self.controllers, self.slots.start
        rank_of = ctl.slot_owner(old.n_devices)
        new_cells = new.leaves.cells
        src = [old.leaves.position(new_cells[surv_pos_new]),
               old.leaves.position(child_parents)]
        tgt = [surv_pos_new, child_pos_new]
        if len(new_parents):
            kids = self.mapping.get_all_children(new_parents)
            src.append(old.leaves.position(kids.reshape(-1)))
            tgt.append(np.repeat(new.leaves.position(new_parents), 8))
        src = np.concatenate(src).astype(np.int64)
        tgt_rank = rank_of[new.leaves.owner[np.concatenate(tgt).astype(np.int64)]]
        src_rank = rank_of[old.leaves.owner[src]]
        cross = src_rank != tgt_rank
        # unique (receiver, old position) pairs: ascending receiver, then
        # ascending position
        key = np.unique(tgt_rank[cross] * len(old.leaves) + src[cross])
        recv_rank, pos = key // len(old.leaves), key % len(old.leaves)
        send_rank = rank_of[old.leaves.owner[pos]]
        dev, row = old.leaves.owner[pos], old.row_of[pos]
        hosts = {n: a.cpu().numpy() for n, a in fields.items()}
        full = {}
        for n, h in hosts.items():
            full[n] = np.zeros((old.n_devices,) + h.shape[1:], h.dtype)
            full[n][lo:lo + len(h)] = h
        sends, recvs, landing = [], [], []
        for q in range(ctl.size):
            if q == ctl.rank:
                continue
            out_sel = (send_rank == ctl.rank) & (recv_rank == q)
            in_sel = (send_rank == q) & (recv_rank == ctl.rank)
            for n, h in hosts.items():
                if out_sel.any():
                    sends.append((q, torch.from_numpy(np.ascontiguousarray(
                        h[dev[out_sel] - lo, row[out_sel]]))))
                if in_sel.any():
                    buf = torch.from_numpy(np.empty(
                        (int(in_sel.sum()),) + h.shape[2:], h.dtype))
                    recvs.append((q, buf))
                    landing.append((n, in_sel, buf))
        Transport(ctl, host=True).exchange(sends, recvs)
        for n, sel, buf in landing:
            full[n][dev[sel], row[sel]] = buf.numpy()
        return full

    # -------------------------------------------------- user neighborhoods

    def add_neighborhood(self, hood_id: int, offsets) -> bool:
        """Add a user-defined neighborhood with its own neighbor lists,
        exchange schedule and iteration masks (reference
        ``dccrg.hpp:6383-6555``).  The offsets must fit inside the default
        neighborhood, so ghost rows and payload layouts are unchanged and
        existing states stay valid."""
        self._assert_no_staged_lb()
        self._assert_initialized()
        # enforced agreement before any early-out: every controller must
        # attempt the same registration, or all of them fail loudly
        from .utils.collectives import assert_agreement

        assert_agreement(
            f"add_neighborhood({hood_id})",
            np.int64(-1 if hood_id is None else hood_id).tobytes()
            + np.asarray(offsets, dtype=np.int64).tobytes(),
        )
        if hood_id in self.neighborhoods or hood_id is None:
            return False
        offs = validate_neighborhood(offsets)
        if self._hood_length == 0:
            default = {tuple(o) for o in self.neighborhoods[None].tolist()}
            if not all(tuple(o) in default for o in offs.tolist()):
                return False
        elif np.abs(offs).max() > self._hood_length:
            return False
        self.neighborhoods[hood_id] = offs
        self._rebuild()
        return True

    def remove_neighborhood(self, hood_id: int) -> bool:
        from .utils.collectives import assert_agreement

        assert_agreement(
            f"remove_neighborhood({hood_id})",
            np.int64(-1 if hood_id is None else hood_id).tobytes(),
        )
        if hood_id is None or hood_id not in self.neighborhoods:
            return False
        del self.neighborhoods[hood_id]
        self._rebuild()
        return True

    # ------------------------------------------------------- load balancing

    def set_cell_weight(self, cell, weight: float) -> bool:
        """Per-cell load-balance weight (reference ``dccrg.hpp:6210-6276``;
        default weight 1)."""
        self._assert_no_staged_lb()
        if not self.leaves.exists(np.uint64(cell)):
            return False
        self.cell_weights[int(cell)] = float(weight)
        return True

    def get_cell_weight(self, cell) -> float:
        return self.cell_weights.get(int(cell), 1.0)

    def pin(self, cell, device: int | None = None) -> bool:
        """Pin a cell to a slot across load balances (its current owner if
        ``device`` is None): reference ``dccrg.hpp:5832-6010``."""
        pos = int(self.leaves.position(np.uint64(cell)))
        if pos < 0:
            return False
        if device is None:
            device = int(self.leaves.owner[pos])
        if not 0 <= device < self.n_devices:
            return False
        self.pin_requests[int(cell)] = int(device)
        return True

    def unpin(self, cell) -> bool:
        if not self.leaves.exists(np.uint64(cell)):
            return False
        self.pin_requests.pop(int(cell), None)
        return True

    def unpin_all_cells(self) -> bool:
        self.pin_requests.clear()
        return True

    def add_partitioning_level(self, processes_per_part: int):
        """Hierarchical partitioning level (reference Zoltan HIER,
        ``dccrg.hpp:5566-5608``): slots are grouped in blocks of
        ``processes_per_part``; cells are balanced over the groups first,
        then within each group.  Later calls subdivide the previous level's
        groups.  A level starts with the reference's default options
        (LB_METHOD=HYPERGRAPH, PHG_CUT_OBJECTIVE=CONNECTIVITY,
        ``dccrg.hpp:5600-5605``)."""
        if int(processes_per_part) < 1:
            raise ValueError(
                "must assign at least 1 process to a hierarchical "
                "partitioning level"
            )
        self._hier_levels.append(int(processes_per_part))
        self._hier_options.append({
            "LB_METHOD": "HYPERGRAPH",
            "PHG_CUT_OBJECTIVE": "CONNECTIVITY",
        })

    def remove_partitioning_level(self, level: int):
        """Remove a hierarchical level (0-based); a level that does not
        exist is a no-op (``dccrg.hpp:5610-5648``)."""
        if 0 <= int(level) < len(self._hier_levels):
            del self._hier_levels[int(level)]
            del self._hier_options[int(level)]

    def add_partitioning_option(self, level: int, name: str, value):
        """Add or overwrite a level's option; a level that does not exist
        is a no-op, reserved names raise (``dccrg.hpp:5650-5706``)."""
        self._check_reserved_option(name)
        if 0 <= int(level) < len(self._hier_options):
            self._hier_options[int(level)][str(name)] = value

    def remove_partitioning_option(self, level: int, name: str):
        """Remove a level's option; no-op where either does not exist
        (``dccrg.hpp:5708-5744``)."""
        if 0 <= int(level) < len(self._hier_options):
            self._hier_options[int(level)].pop(str(name), None)

    def balance_load(self, use_zoltan: bool = True):
        """Repartition cells (method from ``set_load_balancing_method``,
        pins override) and patch the epoch: the reference's three-phase
        ``balance_load`` (``dccrg.hpp:1024-1044, 3741-4147``) in one host
        step.  Payloads follow with ``remap_state`` (an ownership move keeps
        every value); for chunked migration use ``initialize_balance_load``
        / ``continue_balance_load`` / ``finish_balance_load``.  Pending
        adaptation requests are dropped, as in the reference
        (``dccrg.hpp:2666-2668``)."""
        self._assert_initialized()
        self._assert_no_staged_lb()
        with self._span_ctx(), _metrics.phase("loadbalance.migrate"):
            owner = self._compute_new_owner(use_zoltan)
            self._lb_telemetry(self.leaves.owner, owner)
            self._last_new_cells = np.zeros(0, dtype=np.uint64)
            self._last_removed_cells = np.zeros(0, dtype=np.uint64)
            self.amr.clear()
            if np.array_equal(owner, self.leaves.owner):
                # no cell moved: every derived table still holds
                self._prev_epoch = None
                return self
            old_epoch = self.epoch
            self.leaves = LeafSet(cells=self.leaves.cells, owner=owner)
            self._rebuild_incremental(old_epoch)
            self._prev_epoch = _EpochCarry(old_epoch)
            self._harvest_tables(old_epoch)
        return self

    def _lb_telemetry(self, old_owner, new_owner):
        """Record one repartition: cells whose owner changes and the load
        imbalance (max slot load over the mean) before/after."""
        if not _metrics.enabled:
            return
        _metrics.inc("loadbalance.migrations")
        _metrics.inc(
            "loadbalance.cells_migrated",
            int((np.asarray(old_owner) != np.asarray(new_owner)).sum()),
        )

        def imbalance(owner):
            counts = np.bincount(
                np.asarray(owner, dtype=np.int64), minlength=self.n_devices
            )
            avg = counts.mean()
            return float(counts.max() / avg) if avg > 0 else 1.0

        _metrics.gauge("loadbalance.imbalance_before", imbalance(old_owner))
        _metrics.gauge("loadbalance.imbalance_after", imbalance(new_owner))

    def _hierarchical_partition(self, method, weights, hier, options=None):
        """Multi-level partition over a slot hierarchy (reference HIER,
        ``dccrg.hpp:5566-5798``): split cells over groups of ``hier[0]``
        slots, then recurse into each group with the remaining levels, down
        to single slots.  ``hier`` holds ``(processes_per_part,
        level_options)`` pairs; a level splits under the global options
        overlaid with its own.  Levels exhausted with slots remaining fall
        through to the grid's global method."""
        from .parallel.loadbalance import compute_partition

        options = options or {}
        hier = [(int(per), dict(lv_opts or {})) for per, lv_opts in hier]

        def level_method(lv_opts):
            merged = {str(k).upper(): v for k, v in options.items()}
            merged.update({str(k).upper(): v for k, v in lv_opts.items()})
            return str(merged.get("LB_METHOD", method)).upper(), merged

        # one adjacency for the whole hierarchy, restricted per group, built
        # only if some level (or the fall-through) needs it
        methods_used = [level_method(lv_opts)[0] for _, lv_opts in hier]
        methods_used.append(level_method({})[0])
        adjacency = None
        if any(m in ("GRAPH", "HYPERGRAPH") for m in methods_used):
            from .parallel.graph import grid_adjacency

            adjacency = grid_adjacency(self)

        owner = np.zeros(len(self.leaves), dtype=np.int32)

        def recurse(sub, idx, w, levels, first, n_devices, adj):
            if n_devices <= 1 or len(idx) == 0:
                owner[idx] = first
                return
            if not levels:
                ft_method, ft_options = level_method({})
                owner[idx] = first + compute_partition(
                    ft_method, sub, n_devices, w, ft_options, adj
                )
                return
            lv_method, lv_options = level_method(levels[0][1])
            per = max(1, min(levels[0][0], n_devices))
            # groups of `per` slots plus a remainder group: no slot idles
            group_sizes = [per] * (n_devices // per)
            if n_devices % per:
                group_sizes.append(n_devices % per)
            if len(group_sizes) == 1:
                recurse(sub, idx, w, levels[1:], first, n_devices, adj)
                return
            # partition at slot granularity, then merge consecutive parts
            # into groups in proportion to each group's slot count
            fine = compute_partition(
                lv_method, sub, n_devices, w, lv_options, adj
            )
            bounds = np.cumsum([0] + group_sizes)
            group = np.searchsorted(bounds, fine, side="right") - 1
            for gi, n_dev_g in enumerate(group_sizes):
                sel = np.flatnonzero(group == gi)
                if not len(sel):
                    continue
                sub_adj = None
                if adj is not None:
                    from .parallel.graph import restrict_adjacency

                    sub_adj = restrict_adjacency(adj[0], adj[1], sel)
                recurse(
                    _SubGridView(sub, sel), idx[sel],
                    w[sel] if w is not None else None,
                    levels[1:], first + int(bounds[gi]), n_dev_g, sub_adj,
                )

        recurse(self, np.arange(len(self.leaves)), weights, list(hier), 0,
                self.n_devices, adjacency)
        return owner

    def _compute_new_owner(self, use_zoltan: bool) -> np.ndarray:
        """The new owner of every leaf: partitioner, then pin overrides
        (``make_new_partition``, ``dccrg.hpp:8417-8580``)."""
        from .parallel.loadbalance import compute_partition
        from .utils.collectives import sync_partition_inputs

        all_pins, all_weights = sync_partition_inputs(
            self.pin_requests, self.cell_weights
        )
        weights = None
        if all_weights:
            weights = np.ones(len(self.leaves))
            pos, vals = self._positions_of(all_weights, np.float64)
            weights[pos] = vals
        method = self._lb_method if use_zoltan else "NONE"
        options = self.get_partitioning_options()
        if self._hier_levels and method.upper() != "NONE":
            owner = self._hierarchical_partition(
                method, weights, list(zip(self._hier_levels, self._hier_options)),
                options,
            )
        else:
            owner = compute_partition(
                method, self, self.n_devices, weights, options
            )
        owner = np.asarray(owner).astype(np.int32)
        pos, devs = self._positions_of(all_pins, np.int32)
        owner[pos] = devs
        return owner

    def _positions_of(self, per_cell: dict, dtype):
        """(leaf positions, values) of a {cell: value} dict's existing
        cells, in one vectorized lookup."""
        ids = np.fromiter(per_cell.keys(), dtype=np.uint64, count=len(per_cell))
        vals = np.fromiter(per_cell.values(), dtype=dtype, count=len(per_cell))
        pos = self.leaves.position(ids)
        return pos[pos >= 0], vals[pos >= 0]

    def initialize_balance_load(self, use_zoltan: bool = True):
        """Phase 1 of the reference's split balance_load
        (``dccrg.hpp:3741-3884``): compute the new partition and its epoch
        without touching the live grid, whose queries and schedules keep
        the old layout while ``continue_balance_load`` migrates payload
        chunks."""
        self._assert_initialized()
        self._assert_no_staged_lb()
        with self._span_ctx(), _metrics.phase("loadbalance.migrate"):
            owner = self._compute_new_owner(use_zoltan)
            self._lb_telemetry(self.leaves.owner, owner)
            self.amr.clear()
            if np.array_equal(owner, self.leaves.owner):
                self._staged_lb = {"noop": True}
                return self
            new_leaves = LeafSet(cells=self.leaves.cells, owner=owner)
            # an ownership move off the live epoch: the patch keeps every
            # neighbor relation and re-derives the owner-dependent tables
            hints = epoch_shape_hints(self.epoch)
            new_epoch = build_epoch_delta(
                self.epoch, new_leaves, self.n_devices, self.neighborhoods,
                uniform_geometry=self._uniform_geometry(), shape_hints=hints,
                table_pool=self._table_pool,
            )
            if new_epoch is None:
                new_epoch = build_epoch(
                    self.mapping, self.topology, new_leaves, self.n_devices,
                    self.neighborhoods,
                    uniform_geometry=self._uniform_geometry(),
                    shape_hints=hints,
                )
        self._staged_lb = {"noop": False, "leaves": new_leaves,
                           "epoch": new_epoch, "staged": None, "done": 0}
        return self

    def continue_balance_load(self, state=None, max_cells=None) -> bool:
        """Phase 2, repeatable (``dccrg.hpp:3892-3934``): copy the next
        ``max_cells`` leaves' payload rows into the staged new layout, with
        index copies on the grid's device.  Each call reads the state
        passed to it (the reference ships whatever cell data holds at
        continue time).  Returns True while cells remain; without a
        ``state`` there is nothing to move (False)."""
        st = self._staged_lb
        if st is None:
            raise RuntimeError("initialize_balance_load has not been called")
        if st.get("noop") or state is None:
            return False
        N = len(self.leaves)
        old, new = self.epoch, st["epoch"]
        if st["staged"] is None:
            st["staged"] = {
                k: torch.zeros((len(self.slots), new.R) + tuple(v.shape[2:]),
                               dtype=v.dtype, device=self.device)
                for k, v in state.items()
            }
        lo = st["done"]
        hi = N if max_cells is None else min(lo + int(max_cells), N)
        if lo < hi:
            _metrics.inc("loadbalance.staged_rows", hi - lo)
            # unsigned fields move as their same-width signed view (torch
            # has no index_put for them); the rows travel bit for bit
            state = {k: _signed(v) for k, v in state.items()}
            staged = {k: _signed(v) for k, v in st["staged"].items()}
            if self.controllers.multi:
                self._stage_rows_multi(state, staged, old, new, lo, hi)
            else:
                put = lambda a: torch.as_tensor(a.astype(np.int64), device=self.device)
                d_old, r_old = put(old.leaves.owner[lo:hi]), put(old.row_of[lo:hi])
                d_new, r_new = put(new.leaves.owner[lo:hi]), put(new.row_of[lo:hi])
                for k, arr in state.items():
                    staged[k][d_new, r_new] = arr[d_old, r_old].to(self.device)
            st["done"] = hi
        return hi < N

    def _stage_rows_multi(self, state, staged, old, new, lo, hi) -> None:
        """One staged chunk (leaves ``lo:hi``) under several controllers:
        rows that stay on this controller are device row copies; rows
        whose owner moves to another controller go over the payload
        transport, in ascending leaf order on both sides."""
        from .parallel.transport import Transport

        ctl, base = self.controllers, self.slots.start
        rank_of = ctl.slot_owner(self.n_devices)
        d_old = old.leaves.owner[lo:hi].astype(np.int64)
        d_new = new.leaves.owner[lo:hi].astype(np.int64)
        r_old = old.row_of[lo:hi].astype(np.int64)
        r_new = new.row_of[lo:hi].astype(np.int64)
        q_old, q_new = rank_of[d_old], rank_of[d_new]
        put = lambda a: torch.as_tensor(a, device=self.device)
        keep = (q_old == ctl.rank) & (q_new == ctl.rank)
        if keep.any():
            do, ro = put(d_old[keep] - base), put(r_old[keep])
            dn, rn = put(d_new[keep] - base), put(r_new[keep])
            for k, arr in state.items():
                staged[k][dn, rn] = arr[do, ro].to(self.device)
        sends, recvs, landing = [], [], []
        for q in range(ctl.size):
            if q == ctl.rank:
                continue
            out_sel = (q_old == ctl.rank) & (q_new == q)
            in_sel = (q_old == q) & (q_new == ctl.rank)
            for k, arr in state.items():
                if out_sel.any():
                    sends.append((q, arr[put(d_old[out_sel] - base),
                                         put(r_old[out_sel])].contiguous()))
                if in_sel.any():
                    buf = torch.empty((int(in_sel.sum()),) + tuple(arr.shape[2:]),
                                      dtype=arr.dtype, device=self.device)
                    recvs.append((q, buf))
                    landing.append((k, in_sel, buf))
        transport = Transport(ctl)
        need = None
        if transport.direct:
            # every controller's largest channel, from the replicated
            # epochs: one message a field a controller pair
            from .parallel.ipc import channel_bound

            P = ctl.size
            moved = np.bincount(q_old * P + q_new, minlength=P * P).reshape(P, P)
            np.fill_diagonal(moved, 0)
            rbs = [int(np.prod(a.shape[2:], dtype=np.int64)) * a.element_size()
                   for a in state.values()]
            need = max((channel_bound([(int(m) * rb, 1) for rb in rbs])
                        for m in moved.ravel() if m), default=0)
        transport.exchange(sends, recvs, need)
        for k, sel, buf in landing:
            staged[k][put(d_new[sel] - base), put(r_new[sel])] = buf

    def finish_balance_load(self, state=None):
        """Phase 3 (``dccrg.hpp:3942-4147``): commit the new directory and
        epoch.  Remaining chunks are copied from ``state`` first; returns
        the migrated state (tensors on the grid's device) when payloads
        were staged, else the grid.  A partial migration with no ``state``
        to finish from raises."""
        st = self._staged_lb
        if st is None:
            raise RuntimeError("initialize_balance_load has not been called")
        self._last_new_cells = np.zeros(0, dtype=np.uint64)
        self._last_removed_cells = np.zeros(0, dtype=np.uint64)
        if st.get("noop"):
            self._staged_lb = None
            self._prev_epoch = None
            return state if state is not None else self
        if state is not None:
            while self.continue_balance_load(state):
                pass
        elif st["staged"] is not None and st["done"] < len(self.leaves):
            raise RuntimeError(
                "migration is partial; pass the state to finish_balance_load"
            )
        self._staged_lb = None
        old_epoch = self.epoch
        self._prev_epoch = _EpochCarry(old_epoch)
        self.leaves = st["leaves"]
        self.epoch = st["epoch"]
        self._harvest_tables(old_epoch)
        self._halo_cache = {}
        self._unrefine_cache = None
        return self if st["staged"] is None else st["staged"]

    # ------------------------------------------------------------------- IO

    def save_grid_data(self, state, path: str, spec, user_header: bytes = b"",
                       ragged=None, version: int | None = None):
        """Checkpoint grid structure + payloads (reference
        ``save_grid_data``, ``dccrg.hpp:1089-1716``) in the JAX package's
        format.  ``ragged`` maps a variable-size field to its count field:
        only ``count[i]`` rows are written per cell.  ``version=1`` writes
        the legacy CRC-less layout (default: the v2 format with CRCs)."""
        from .io.checkpoint import CHECKPOINT_VERSION
        from .io.checkpoint import save_grid_data as _save

        with self._span_ctx():
            _save(self, state, path, spec, user_header, ragged=ragged,
                  version=CHECKPOINT_VERSION if version is None else version)

    @staticmethod
    def load_grid_data(path: str, spec, n_devices=None, device=None,
                       ragged=None, on_error: str = "raise"):
        """Recreate a saved grid on ``n_devices`` slots of ``device``
        (default CUDA); any slot count works (reference
        ``load_grid_data``, ``dccrg.hpp:1742-2404``).  Returns ``(grid,
        state, user_header)``; a torn or corrupt file raises
        :class:`~dccrg_tpu_torch.io.checkpoint.CheckpointError` naming the
        failing section.  ``on_error="salvage"`` instead recovers every
        intact cell and returns ``(grid, state, user_header,
        lost_cells)``."""
        from .io.checkpoint import load_grid_data as _load

        return _load(path, spec, n_devices=n_devices, device=device,
                     ragged=ragged, on_error=on_error)

    @staticmethod
    def start_loading_grid_data(path: str, spec, n_devices=None, device=None,
                                ragged=None, on_error: str = "raise"):
        """Chunked load: returns a loader; call
        ``loader.continue_loading_grid_data(max_cells)`` until it returns
        False, then ``loader.finish_loading_grid_data()`` (reference
        ``dccrg.hpp:1742-2404``)."""
        from .io.checkpoint import start_loading_grid_data as _start

        return _start(path, spec, n_devices=n_devices, device=device,
                      ragged=ragged, on_error=on_error)

    def save_checkpoint(self, state, directory: str, spec, keep: int = 3,
                        user_header: bytes = b"", ragged=None) -> int:
        """Commit one generation into a crash-safe checkpoint lineage
        (``resilience/manager.py``): fsync'd atomic write, checksummed
        MANIFEST, oldest generations beyond ``keep`` rotated out.
        Returns the committed generation number."""
        from .resilience.manager import CheckpointLineage

        return CheckpointLineage(directory, keep=keep).commit(
            self, state, spec, user_header=user_header, ragged=ragged
        )

    @staticmethod
    def resume_latest(directory: str, spec, n_devices=None, device=None,
                      ragged=None, verify: bool = True):
        """Resume from the newest VALID generation in a lineage
        directory onto ``n_devices`` slots of ``device`` (default CUDA),
        scanning back past torn/corrupt ones and re-verifying the restored
        grid with ``utils.verify.verify_grid``.  Returns ``(grid, state,
        user_header, generation)``; raises
        :class:`~dccrg_tpu_torch.io.checkpoint.CheckpointError` when nothing
        in the lineage is recoverable."""
        from .resilience.manager import CheckpointLineage

        return CheckpointLineage(directory).latest_valid(
            spec, n_devices=n_devices, device=device, ragged=ragged,
            verify=verify,
        )

    def write_vtk_file(self, path: str, scalars: dict | None = None,
                       binary: bool = True):
        """Dump leaf-cell geometry (+ optional ``{name: per-cell values}``
        scalars, host arrays in ``get_cells()`` order) as legacy VTK
        (reference ``dccrg.hpp:3298-3370``); BINARY encoding by default,
        ``binary=False`` for ASCII."""
        from .io.vtk import write_vtk_file as _vtk

        _vtk(self, path, scalars, binary=binary)

    # -------------------------------------------------------- introspection

    @property
    def telemetry(self):
        """The process-wide metrics registry (``obs.metrics``) — the
        statistics accessor in dccrg's getter style.  Use
        ``grid.telemetry.report()`` for a raw snapshot, ``grid.report()``
        for the snapshot annotated with this grid's shape."""
        return _metrics

    @property
    def events(self):
        """The process-wide event timeline (``obs.timeline``): the
        individual begin/end spans behind the aggregate phase timers.
        Export with ``obs.export_chrome_trace(path)`` for perfetto."""
        return _timeline

    def report(self) -> dict:
        """Telemetry snapshot (phases, counters, gauges, histograms from
        every instrumented seam) plus this grid's current shape and the
        event-timeline fill state.  The same structure
        ``obs.export_json`` writes to ``telemetry.json``."""
        rep = _metrics.report()
        rep["events"] = _timeline.summary()
        if self.initialized:
            rep["grid"] = {
                "grid_id": int(self.grid_id),
                "n_cells": int(len(self.leaves)),
                "n_devices": int(self.n_devices),
                "rows_per_device": int(self.epoch.R),
                "ghost_cells": int(self.epoch.n_ghost.sum()),
                "neighborhoods": len(self.neighborhoods),
                "max_refinement_level": int(
                    self.mapping.max_refinement_level
                ),
            }
        return rep


class _SubGridView:
    """Grid-shaped view over a subset of leaves, for hierarchical
    partitioning."""

    def __init__(self, grid, idx):
        self.mapping = grid.mapping
        self.geometry = grid.geometry
        self.leaves = LeafSet(cells=grid.leaves.cells[idx],
                              owner=grid.leaves.owner[idx])


def _signed(t):
    """``t`` itself, or for an unsigned integer tensor its same-width signed
    view (``parallel.halo_dma.AS_SIGNED``): the same bytes, indexable."""
    s = AS_SIGNED.get(t.dtype)
    return t if s is None else t.view(s)


class _EpochCarry:
    """Slim view of a pre-change epoch: what ``remap_state`` needs to carry
    payloads across a structural change (the old leaf directory, row
    assignment and row budget); the old hood tables are not kept."""

    __slots__ = ("leaves", "row_of", "n_devices", "R")

    def __init__(self, epoch):
        self.leaves = epoch.leaves
        self.row_of = epoch.row_of
        self.n_devices = epoch.n_devices
        self.R = epoch.R


def _face_direction(off, own_len: int, nbr_len: int) -> int:
    """Classify a neighbor-list offset as a face direction (0 = not a face
    neighbor), following the advection workload's offset logic
    (reference tests/advection/solve.hpp:71-123)."""
    ox, oy, oz = (int(v) for v in off)
    for axis, o in ((1, ox), (2, oy), (3, oz)):
        others = [v for a, v in ((1, ox), (2, oy), (3, oz)) if a != axis]
        # face contact on the negative side: neighbor ends where cell begins
        if o == -nbr_len and all(-nbr_len < v < own_len for v in others):
            return -axis
        if o == own_len and all(-nbr_len < v < own_len for v in others):
            return axis
    return 0
