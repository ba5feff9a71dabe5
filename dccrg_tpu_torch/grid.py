"""The Grid: dccrg's user model on one CUDA device (PyTorch).

The same fluent surface as the JAX package's ``Grid`` (builder ->
``initialize`` -> cells, payloads, refinement, halo), with cell payloads
held as SoA ``[n_devices, rows, ...]`` torch tensors.  All ``n_devices``
slots live on one device, so the leading axis plays the role of the JAX
mesh axis and device-count invariance stays testable.

Grid and refinement metadata stay host-side numpy, as in the JAX package.
Every structural change (``stop_refining``) rebuilds the epoch in full with
``build_epoch``; the JAX package's incremental patch of the epoch is an
optimisation whose oracle is that full build, and it is not ported yet.
A patched epoch may give a leaf another row than a full build does, so
states are compared across the packages by cell id, never by row.

Ghost refresh is blocking (``update_copies_of_remote_neighbors``) or
split-phase (``start_remote_neighbor_copy_updates`` /
``wait_remote_neighbor_copy_updates``), under an optional per-cell payload
policy (``set_cell_datatype``); see ``parallel/halo.py``.

Load balancing, user neighborhoods and checkpoint I/O raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import numpy as np
import torch

from .amr.refinement import AmrQueues
from .convert import torch_dtype
from .core.mapping import Mapping
from .core.neighborhood import default_neighborhood
from .core.neighbors import LeafSet
from .core.topology import Topology
from .geometry import CartesianGeometry, NoGeometry
from .parallel.epoch import build_epoch
from .parallel.halo import HaloExchange
from .parallel.partition import block_partition, hilbert_partition, morton_partition
from .parallel.shapes import epoch_shape_hints, signature_of

__all__ = ["Grid", "CellSpec", "resolve_device"]

#: field name -> (per-cell shape tuple, dtype)
CellSpec = dict


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


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item {item})"
    )


class Grid:
    # ------------------------------------------------------------- builder

    def __init__(self):
        self._length = (1, 1, 1)
        self._max_ref_lvl = 0
        self._periodic = (False, False, False)
        self._hood_length = 1
        self._lb_method = "RCB"
        self._geometry_factory = None
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

    def initialize(self, n_devices: int | None = None, device=None) -> "Grid":
        """Create level-0 cells, stripe them over ``n_devices`` slab slots
        (default 1) and build all derived state.  Payloads are allocated on
        ``device`` (default CUDA; ``"cpu"`` must be asked for)."""
        self._assert_uninitialized()
        self.device = resolve_device(device)
        self.n_devices = 1 if n_devices is None else int(n_devices)
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        self.mapping = Mapping(length=self._length, max_refinement_level=self._max_ref_lvl)
        self.topology = Topology(periodic=self._periodic)
        factory = self._geometry_factory or (lambda m, t: NoGeometry(m, t))
        self.geometry = factory(self.mapping, self.topology)
        self.neighborhoods = {None: default_neighborhood(self._hood_length)}
        self._ring_hints = {}
        self._cell_datatype = None
        self.amr = AmrQueues()
        # load-balance weights and pins: commit_adaptation hands them from
        # refined cells to their children; empty until balance_load lands
        self.cell_weights = {}
        self.pin_requests = {}
        self._last_new_cells = np.zeros(0, dtype=np.uint64)
        self._last_removed_cells = np.zeros(0, dtype=np.uint64)
        self._last_adaptation_delta = None
        self._prev_epoch = None

        n0 = int(np.prod(self._length))
        cells = np.arange(1, n0 + 1, dtype=np.uint64)
        if self._lb_method in ("HSFC", "SFC", "HILBERT"):
            owner = hilbert_partition(self.mapping, cells, self.n_devices)
        elif self._lb_method == "MORTON":
            owner = morton_partition(self.mapping, cells, self.n_devices)
        else:
            owner = block_partition(cells, self.n_devices)
        self.leaves = LeafSet(cells=cells, owner=owner.astype(np.int32))
        self.initialized = True
        self._rebuild()
        return self

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

    # ---------------------------------------------------------- cell views

    def _assert_initialized(self):
        if not self.initialized:
            raise RuntimeError("grid not initialized")

    def get_cells(self) -> np.ndarray:
        """All existing (leaf) cells, ascending id — global view."""
        self._assert_initialized()
        return self.leaves.cells.copy()

    def remote_cells(self, device: int) -> np.ndarray:
        """Ghost cells held by a device slot."""
        return self.leaves.cells[self.epoch.ghost_pos[device]]

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

    # ------------------------------------------------------------ payloads

    def new_state(self, spec: CellSpec, fill=0):
        """Allocate SoA payload tensors ``[D, R, *shape]``, one per field."""
        self._assert_initialized()
        D, R = self.n_devices, self.epoch.R
        return {
            name: torch.full((D, R) + tuple(shape), fill,
                             dtype=torch_dtype(dtype), device=self.device)
            for name, (shape, dtype) in spec.items()
        }

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
        host[dev, row] = values
        return {**state, field: torch.from_numpy(host).to(state[field].device)}

    def get_cell_data(self, state, field: str, ids):
        """Host-side gather of per-cell values (verification/I/O path)."""
        dev, row = self._owner_rows(ids, "get_cell_data")
        return state[field].cpu().numpy()[dev, row]

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
                ring_hints=self._ring_hints,
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

    def update_copies_of_remote_neighbors(self, state, hood_id=None):
        """Blocking ghost refresh (reference ``dccrg.hpp:966-1000``)."""
        return self.halo(hood_id)(state)

    def start_remote_neighbor_copy_updates(self, state, hood_id=None):
        """Split-phase start (reference ``dccrg.hpp:5010-5105``): gather the
        ghost payloads (on CUDA, on a side stream) and return a
        ``HaloHandle``; the state is untouched, so work on inner cells can
        be queued before ``wait_remote_neighbor_copy_updates(state,
        handle)`` merges the payloads."""
        return self.halo(hood_id).start(state)

    def wait_remote_neighbor_copy_updates(self, state, handle=None, hood_id=None):
        """Split-phase wait: merge the ``start`` handle's payloads into the
        ghost rows.  Without a handle this is a blocking ghost refresh."""
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

    def stop_refining(self) -> np.ndarray:
        """Commit all queued refines/unrefines (veto -> induce -> override
        -> execute, reference ``dccrg.hpp:3461-3485``) and rebuild the
        epoch; returns the new cells.  States allocated before this call
        are carried over with ``remap_state``."""
        self._assert_initialized()
        from .amr.refinement import commit_adaptation

        old_epoch = self.epoch
        new_cells, removed, delta = commit_adaptation(self)
        self._last_new_cells = new_cells
        self._last_removed_cells = removed
        self._last_adaptation_delta = delta
        if not len(new_cells) and not len(removed):
            # nothing changed: keep the current epoch
            self._prev_epoch = None
            return new_cells.copy()
        self._rebuild()
        self._prev_epoch = _EpochCarry(old_epoch)
        return new_cells.copy()

    def get_removed_cells(self) -> np.ndarray:
        """Cells removed by the last ``stop_refining`` (their parents are
        now leaves) — reference ``dccrg.hpp:3488-3520``."""
        return self._last_removed_cells.copy()

    def get_last_adaptation_delta(self):
        """The complete touched set of the last commit
        (``amr.refinement.AdaptationDelta``); None before the first."""
        return self._last_adaptation_delta

    def remap_state(self, state, policy=None):
        """Carry a payload state across the last structural change.

        Surviving cells keep their values.  Per-field ``policy`` entries
        control the rest: ``refine`` — how children get values from their
        refined parent ("inherit" default, or "zero"); ``unrefine`` — how a
        new parent reduces its removed children ("mean" default, "sum", or
        "zero") — the array form of the reference's parent/child data
        handling after stop_refining (tests/advection/adapter.hpp:230-292).
        Runs on the host, like the JAX package's."""
        if self._prev_epoch is None or self._prev_epoch is self.epoch:
            return state
        old, new = self._prev_epoch, self.epoch
        policy = policy or {}
        out = {}
        new_cells = new.leaves.cells

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

        for name, arr in state.items():
            host_old = arr.cpu().numpy()
            if host_old.ndim < 2 or host_old.shape[:2] != (
                old.n_devices, old.R
            ):
                # not a per-cell [D, R, ...] payload: carried unchanged
                out[name] = arr
                continue
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

            out[name] = torch.from_numpy(host_new).to(arr.device)
        return out

    # ------------------------------------------- not in this slice (ROADMAP)

    def add_neighborhood(self, hood_id: int, offsets) -> bool:
        _not_in_slice("User neighborhoods", "6")

    def balance_load(self, *args, **kwargs):
        _not_in_slice("balance_load", "6")

    def save_grid_data(self, *args, **kwargs):
        _not_in_slice("Checkpoint I/O", "11")


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
