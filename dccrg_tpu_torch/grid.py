"""The Grid: dccrg's user model on one CUDA device (PyTorch).

The same fluent surface as the JAX package's ``Grid`` (builder ->
``initialize`` -> cells, payloads, epoch), with cell payloads held as SoA
``[n_devices, rows, ...]`` torch tensors.  All ``n_devices`` slots live on
one device, so the leading axis plays the role of the JAX mesh axis and
device-count invariance stays testable.

Grid and refinement metadata stay host-side numpy, as in the JAX package.
This slice carries the uniform grid the dense advection path runs on;
adaptive refinement, load balancing, halo schedules and I/O raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import numpy as np
import torch

from .convert import torch_dtype
from .core.mapping import Mapping
from .core.neighborhood import default_neighborhood
from .core.neighbors import LeafSet
from .core.topology import Topology
from .geometry import CartesianGeometry, NoGeometry
from .parallel.epoch import build_epoch
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
        precondition for the dense fast path's metric factors."""
        return bool(getattr(self.geometry, "uniform_level0", False))

    def shape_signature(self):
        """The current epoch's shape signature (see ``parallel/shapes.py``)."""
        return signature_of(self.epoch, self._ring_hints)

    def _rebuild(self):
        self.epoch = build_epoch(
            self.mapping, self.topology, self.leaves, self.n_devices,
            self.neighborhoods,
            uniform_geometry=self._uniform_geometry(),
            shape_hints=epoch_shape_hints(getattr(self, "epoch", None)),
        )

    # ------------------------------------------------------- cells, payloads

    def _assert_initialized(self):
        if not self.initialized:
            raise RuntimeError("grid not initialized")

    def get_cells(self) -> np.ndarray:
        """All existing (leaf) cells, ascending id — global view."""
        self._assert_initialized()
        return self.leaves.cells.copy()

    def new_state(self, spec: CellSpec, fill=0):
        """Allocate SoA payload tensors ``[D, R, *shape]``, one per field."""
        self._assert_initialized()
        D, R = self.n_devices, self.epoch.R
        return {
            name: torch.full((D, R) + tuple(shape), fill,
                             dtype=torch_dtype(dtype), device=self.device)
            for name, (shape, dtype) in spec.items()
        }

    # ------------------------------------------- not in this slice (ROADMAP)

    def halo(self, hood_id=None, cell_datatype=...):
        _not_in_slice("The halo exchange schedule", "12")

    def update_copies_of_remote_neighbors(self, state, hood_id=None):
        _not_in_slice("The halo exchange", "12")

    def add_neighborhood(self, hood_id: int, offsets) -> bool:
        _not_in_slice("User neighborhoods", "6")

    def refine_completely(self, cell):
        _not_in_slice("Adaptive refinement", "6")

    def unrefine_completely(self, cell):
        _not_in_slice("Adaptive refinement", "6")

    def stop_refining(self, *args, **kwargs):
        _not_in_slice("Adaptive refinement", "6")

    def balance_load(self, *args, **kwargs):
        _not_in_slice("balance_load", "6")

    def save_grid_data(self, *args, **kwargs):
        _not_in_slice("Checkpoint I/O", "11")
