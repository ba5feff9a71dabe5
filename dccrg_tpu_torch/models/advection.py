"""3-D upwind finite-volume advection — the framework's north-star workload
(reference ``tests/advection``: cell layout ``cell.hpp:36-44``, flux solver
``solve.hpp:43-260``, initial condition ``initialize.hpp:36-80``, rotating
velocity field ``solve.hpp:336-346``, adaptation ``adapter.hpp:47-310``).

A port of the JAX package's ``models/advection.py``, with two layouts:

* dense (a uniform slab grid): payloads are ``[D, nz_local, ny, nx]``
  z-slab tensors, every face flux is a shifted neighbor read, and the z
  halo is the two ring planes of ``parallel/dense.py::HaloExtend``;
* general (any refined grid): payloads are ``[D, R]`` rows of the epoch,
  every cell accumulates its own flux from its face-neighbor entries in
  fixed slot order (``ordered_sum``), ghost densities are refreshed by the
  halo exchange every step, and face classification is precomputed on the
  host per epoch (``build_face_tables``).

Dispatch, with the JAX package's labels.  Dense: float32 with
``use_kernels`` goes through the CUDA kernels of ``ops/dense_advection.py``
— the whole-run kernel for ``run`` on one device when the block fits, the
blocked step kernel when a z-block size divides ``nz_local``, else the
plane step kernel; float64 or ``use_kernels=False`` runs the plain step
body.  General: ``run`` takes, as the JAX package's ``_build_flat_run``
does (``_flat_kind``), with ``use_kernels``:

* 3 or more leaf levels: ``"ml_pallas"`` (kernel B6, ``flat_ml_run``) on
  one slot in float32 when the grid fits, else ``"ml"`` (the multi-level
  pyramid form in plain torch, any slot count, float32 or float64);
* levels {0, 1} on D > 1 slots: ``"sharded"`` (the z-slab form in plain
  torch, float32 or float64);
* levels {0, 1} on one slot in float32: ``"pallas"`` (kernel B5,
  ``flat_amr_run``);

and, with ``allow_boxed``, the boxed per-level passes
(``models/boxed_advection.py``) when a flat form qualifies and its voxel
count exceeds the edge constant times the boxed volume (``_prefer_boxed``;
the ``"sharded"`` form is never traded).  Every other case, and every
``step``, runs the gather step; ``use_kernels=False`` turns off the flat
forms, so ``run`` is the gather step.  Where no flat form qualifies, the
JAX package runs the boxed passes; the port keeps the gather step, which
they beat by 1.1-1.4x on two levels and lose to by 3x on three on an
H100 (``chip_smoke.py`` phase 24 times both).

``overlap=True`` pins the general path (no dense path, no flat run) and
makes ``step`` / ``run`` the split-phase step: start the density halo
(kernel B9 on a side stream on CUDA), update the inner rows, which read no
ghost, wait, then update the outer rows — bitwise equal to the gather step.

Under several controllers (``parallel/mesh.py``) the dense layout holds
this controller's slots, ``[len(grid.slots), nz_local, ny, nx]``: the z
ring's end planes cross the transport (``HaloExtend``'s controller form),
reads are collectives and the sums keep the one-controller order, so
every result is bitwise one controller's on the same slots.  On a refined
grid ``run`` takes the same form there as on one controller: the
``sharded`` and ``ml`` flat forms and the boxed passes hold this
controller's slots and ride the same z ring (B5 and B6 are one-slot
kernels, and several controllers mean at least two slots).  The split
step's inner and outer tables hold this controller's slots at every slot's
width; its ``start`` packs (B9) and posts the transport, ``finish`` waits
and merges (B9).  The cohort forms (``batch_step_spec``, ``_wide_spec``)
run over member stacks of this controller's slots: the dense ring carries
every member's planes in one batch, and ``MemberExchange`` every member's
rows in one message a peer.

On CPU tensors each kernel wrapper computes with its plain twin.  A kernel
that fails to build or launch raises: there is no fallback to another path.

Telemetry (``obs.metrics``; none of it synchronises or reads the device):
the spans ``advection.init``, ``advection.initialize_state``,
``advection.set_cell_data``, ``advection.max_time_step``, ``advection.step``
(a public ``step`` call) and ``advection.run`` (its ``path`` in the span's
args: ``fused``, ``dense``, ``flat``, ``boxed``, ``general`` or ``split``),
inside which ``advection.record`` (``_record_run``) and, on kernels B5 / B6,
``advection.flat.inputs``, ``advection.flat.launch`` and
``advection.flat.write_back``; the counters ``advection.host_reads{site}``
(blocking device-to-host reads) and ``advection.h2d_copies{site}`` /
``advection.h2d_bytes{site}`` (host arrays put on the device) of the stepping
and ``dt`` paths, each counted where the call issues it, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import numpy_dtype, torch_dtype
from ..obs import fused
from ..obs.registry import metrics as _metrics
from ..ops.dense_advection import (
    dense_step_arith,
    flux_update,
    flux_update_blocked,
    flux_update_fits,
    fused_run,
    fused_run_fits,
    pick_step_block,
)
from ..ops.flat_amr import (
    build_flat_amr_sharded,
    build_flat_amr_tables,
    build_flat_ml_tables,
    compute_flat_ml_weights,
    compute_flat_weights,
    flat_amr_run,
    flat_amr_run_plain,
    flat_ml_kernel_fits,
    flat_ml_run,
    flat_ml_run_plain,
    make_flat_amr_run_sharded,
    make_flat_ml_run,
)
from ..parallel.dense import HaloExtend
from ..parallel.stencil import (StencilTables, gather_neighbors, member_index,
                                member_rows, ordered_sum, split_rows)
from ..utils.collectives import assert_agreement

__all__ = ["Advection", "build_face_tables", "build_split_tables",
           "FLAT_BOXED_EDGE", "ML_BOXED_EDGE"]

#: prefer the boxed passes over kernel B5 when the flat voxel count exceeds
#: this times the boxed volume: B5's voxel-updates/s over the boxed passes'
#: on the 48^3 refined grid, 249.7 on an NVIDIA H100 80GB HBM3 at 700 W
#: (``kernel_probe.py boxed-edge``; ``chip_smoke.py`` phase 24 measures it
#: again each run, and it swings 2x between runs: 223-426).  The JAX
#: package's default is 2.0, its chip's ratio; here the boxed passes are
#: host-launched torch ops, 0.665 ms a step on refined and 2.29 ms on
#: refined3.  The flat form holds at most 8^(levels - 1) voxels a leaf, so
#: neither this edge nor the B6 one below can choose the boxed passes on
#: two or three levels.
FLAT_BOXED_EDGE = 250.0
#: the same edge for the multi-level forms, by ``_flat_kind``: B6 over the
#: boxed passes on the 16^3 three-level grid, 184.7 (phase 24: 249-424),
#: and the float64 ``ml`` pyramid form over the float64 boxed passes there,
#: 7.0 (the same card and probe; the JAX package's defaults are 2.0 and
#: 1.5).
ML_BOXED_EDGE = {"ml_pallas": 180.0, "ml": 7.0}

#: marks the boxed layout as not yet built (``Advection.boxed``)
_UNBUILT = object()

#: the ``advection.run`` span's args, by run path
_RUN_ARGS = {p: {"path": p} for p in
             ("fused", "dense", "flat", "boxed", "general", "split")}


def _count_reads(site: str, reads: int, copies: int = 0, nbytes: int = 0) -> None:
    """Count ``reads`` blocking device-to-host reads and ``copies``
    host-to-device copies of ``nbytes`` in all at ``site`` (the
    ``advection.host_reads`` / ``h2d_copies`` / ``h2d_bytes`` series)."""
    if not _metrics.enabled:
        return
    labels = {"site": site}
    _metrics.inc_many([(name, v, labels) for name, v in (
        ("advection.host_reads", reads), ("advection.h2d_copies", copies),
        ("advection.h2d_bytes", nbytes)) if v])


def build_face_tables(grid, hood_id, tables, dtype, hood_arrays=None):
    """Classify each neighbor entry as a face neighbor with a signed
    direction, reproducing the offset logic of ``solve.hpp:71-123``
    (overlap in exactly 2 dims + contact in 1), plus the physical factors
    every finite-volume workload prices faces with.  ``hood_arrays`` =
    ``(nbr_offset, nbr_len, nbr_rows, nbr_valid)`` replaces the
    neighborhood's own tables (the wide-halo plan's, which cover every row
    of every slot).  A neighbor listed more
    than once across the same face (neighborhood length >= 1) is priced at
    its first entry only (``core.neighbors.first_faces``); at length 0
    every face entry is already unique.  Returns ``(host, dev)``: numpy tables
    {face_dir, min_area, cell_axis_len, nbr_axis_len, inv_volume} and the
    same as tensors on the grid's device (float tables in ``dtype``,
    axis_idx and the direction's sign added).

    The classification and the face factors are computed on the valid and
    the face entries only, then placed in the dense ``[D, R, K]`` tables
    (a non-face entry reads its x lengths and no area, as the JAX
    package's dense form gives it): the JAX package's values, at a cost
    that follows the faces rather than ``K``."""
    from ..core.neighbors import face_directions, first_faces

    epoch = grid.epoch
    hood = epoch.hoods[hood_id]
    nbr_offset, nbr_len, nb, nbr_valid = (
        (hood.nbr_offset, hood.nbr_len, hood.nbr_rows, hood.nbr_valid)
        if hood_arrays is None else hood_arrays)
    D, R, K = nb.shape
    v = np.nonzero(nbr_valid)
    direction = np.zeros((D, R, K), dtype=np.int8)    # signed axis or 0
    direction[v] = face_directions(
        nbr_offset[v].astype(np.int64),
        epoch.cell_len[v[0], v[1]].astype(np.int64),
        nbr_len[v].astype(np.int64),
    )
    f = np.nonzero(direction)
    keep = first_faces(f[0] * R + f[1],
                       nb[f].astype(np.int64) * 8 + direction[f] + 3)
    direction[tuple(i[~keep] for i in f)] = 0

    # physical areas/volumes from the geometry tables
    length = tables.length_host                      # [D, R, 3]
    vol = length.prod(axis=-1)                       # [D, R]
    ar_d = np.arange(D)[:, None, None]
    cell_axis_len = np.broadcast_to(length[:, :, None, 0], (D, R, K)).copy()
    nbr_axis_len = length[ar_d, nb, 0]
    min_area = np.zeros((D, R, K))
    f = np.nonzero(direction)
    ai = np.abs(direction[f]).astype(np.int64) - 1
    c3, n3 = length[f[0], f[1]], length[f[0], nb[f]]  # [F, 3] each
    e = np.arange(len(ai))
    o1, o2 = (ai + 1) % 3, (ai + 2) % 3
    min_area[f] = np.minimum(c3[e, o1] * c3[e, o2], n3[e, o1] * n3[e, o2])
    cell_axis_len[f] = c3[e, ai]
    nbr_axis_len[f] = n3[e, ai]
    host = {
        "face_dir": direction,
        "min_area": min_area,
        # axis lengths for face-velocity interpolation
        "cell_axis_len": cell_axis_len,
        "nbr_axis_len": nbr_axis_len,
        "inv_volume": np.where(vol > 0, 1.0 / vol, 0.0),
    }
    ai_all = np.maximum(np.abs(direction.astype(np.int64)) - 1, 0)
    tdt = torch_dtype(dtype)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(grid.slot_view(a)),
                                        device=grid.device).to(dt)
    dev = {name: put(host[name], tdt)
           for name in ("min_area", "cell_axis_len", "nbr_axis_len", "inv_volume")}
    dev["face_dir"] = put(direction, torch.int8)
    dev["axis_idx"] = put(ai_all, torch.int8)
    dev["sign"] = put(np.sign(direction), tdt)
    return host, dev


def build_split_tables(grid, hood_id, host_face, dtype, extra=None):
    """The inner and outer row sets of a split-phase step (the JAX
    package's ``build_split_tables``, shared by Advection and Vlasov): the
    rows of :func:`split_rows`, with the neighbor rows and the face tables
    of :func:`build_face_tables` (``host_face``, its host dict) restricted
    to them.  ``extra`` maps names to further host tables ``[..., D, R]``,
    restricted the same way and shipped in ``dtype``.  Returns ``(inner,
    outer)`` dicts of device tensors; pad lanes are scratch rows whose face
    entries are all masked (``face_dir == 0``), so they contribute
    nothing.  Under several controllers the tables are this controller's
    slots, ``[len(grid.slots), W]``, with the width W of every slot's rows
    (replicated, so every controller builds the same shapes); a row with a
    neighbour on another controller has it on another slot, so it is
    outer, as on one controller."""
    hood = grid.epoch.hoods[hood_id]
    ar = np.arange(grid.n_devices)[grid.slots.start:grid.slots.stop, None]
    tdt = torch_dtype(dtype)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), device=grid.device).to(dt)
    sides = []
    for rows in split_rows(grid, hood_id):
        rows = grid.slot_view(rows)
        fd = host_face["face_dir"][ar, rows]
        sub = {
            "rows": put(rows, torch.int64),
            "nbr_rows": put(hood.nbr_rows[ar, rows], torch.int64),
            "face_dir": put(fd, torch.int8),
            "axis_idx": put(np.maximum(np.abs(fd.astype(np.int64)) - 1, 0), torch.int8),
            "sign": put(np.sign(fd), tdt),
        }
        for name in ("min_area", "cell_axis_len", "nbr_axis_len", "inv_volume"):
            sub[name] = put(host_face[name][ar, rows], tdt)
        for name, arr in (extra or {}).items():
            sub[name] = put(arr[..., ar, rows], tdt)
        sides.append(sub)
    return sides[0], sides[1]


def _face_update(t, rho_c, rho_n, v_c, v_n, dt):
    """``rho_c`` plus its upwind face fluxes summed in slot order (the JAX
    package's step body): the face velocity ``(cl*v_nbr + nl*v_cell)/(cl +
    nl)`` (solve.hpp:168-175), the upwind density, outflow on a +dir face
    subtracted and on a -dir face added (solve.hpp:227-233).  ``t`` holds
    the face tables of the cells ``rho_c`` (all rows, or one split side),
    ``rho_n`` / ``v_n`` their neighbors' density and (vx, vy, vz), ``v_c``
    the cells' own velocity."""
    sgn, ai = t["sign"], t["axis_idx"]
    v_cell = torch.where(
        ai == 0, v_c[0][..., None],
        torch.where(ai == 1, v_c[1][..., None], v_c[2][..., None]),
    )
    v_nbr = torch.where(ai == 0, v_n[0], torch.where(ai == 1, v_n[1], v_n[2]))
    cl, nl = t["cell_axis_len"], t["nbr_axis_len"]
    v_face = (cl * v_nbr + nl * v_cell) / (cl + nl)
    r_c = rho_c[..., None]
    upwind_pos = torch.where(v_face >= 0, r_c, rho_n)
    upwind_neg = torch.where(v_face >= 0, rho_n, r_c)
    upwind = torch.where(sgn > 0, upwind_pos, upwind_neg)
    face_flux = upwind * dt * v_face * t["min_area"]
    zero = torch.zeros((), dtype=rho_c.dtype, device=rho_c.device)
    contrib = torch.where(t["face_dir"] != 0, -sgn * face_flux, zero)
    return rho_c + ordered_sum(contrib, axis=-1) * t["inv_volume"]


class _FlatRun:
    """A refined grid's whole run on the flat voxel layout: gather the
    voxels of each field with ``state[f][0][rows]``, compute the face
    weights once, advance every step in one kernel launch, and write the
    leaf rows back with ``where(wb_valid, out.flat[wb_rows], density[0])``.

    ``inputs(state)`` gives the kernel wrapper's arguments before ``dt`` and
    ``steps`` (so a caller can hand the same ones to the plain twin), and
    ``write_back(state, V)`` the state a voxel array stands for."""

    def __init__(self, tables, device, rows, wb_rows, wb_valid, masks,
                 weights, kernel, plain, kwargs):
        put = lambda a, dt=torch.int64: torch.as_tensor(
            np.ascontiguousarray(a), device=device).to(dt)
        self.tables = tables
        self.shape = tuple(tables["shape"])
        self.rows = put(rows)
        self.wb_rows = put(wb_rows)
        self.wb_valid = put(wb_valid, torch.bool)
        self.masks = [put(m, torch.float32) if not isinstance(m, list)
                      else [put(c, torch.float32) for c in m] for m in masks]
        self.weights = weights
        self.kernel, self.plain, self.kwargs = kernel, plain, kwargs

    @classmethod
    def two_level(cls, t, device):
        leaf = t["leaf_fine"]
        masks = [leaf.astype(np.float64) / t["vol_f"],
                 (~leaf).astype(np.float64) / t["vol_c"]]
        return cls(t, device, t["rows"], t["wb_rows"], t["wb_valid"], masks,
                   compute_flat_weights, flat_amr_run, flat_amr_run_plain, {})

    @classmethod
    def multi_level(cls, t, device):
        masks = [t["updf"][0], t["pool"][0], [c[0] for c in t["cap_origin"]]]
        return cls(t, device, t["rows"][0], t["wb_rows"][0], t["wb_valid"][0],
                   masks, compute_flat_ml_weights, flat_ml_run,
                   flat_ml_run_plain, {"cap_active": list(t["cap_active"])})

    def inputs(self, state):
        def field(name):
            return state[name][0][self.rows].reshape(self.shape).to(torch.float32)

        (wpx, wnx), (wpy, wny), (wpz, wnz) = self.weights(
            self.tables, field("vx"), field("vy"), field("vz"))
        return (field("density"), wpx, wnx, wpy, wny, wpz, wnz, *self.masks)

    def write_back(self, state, V):
        rho = torch.where(self.wb_valid, V.reshape(-1)[self.wb_rows],
                          state["density"][0])
        return {**state, "density": rho[None].to(state["density"].dtype),
                "flux": torch.zeros_like(state["flux"])}

    def run(self, state, steps, dt):
        with _metrics.phase("advection.flat.inputs"):
            args = self.inputs(state)
        with _metrics.phase("advection.flat.launch"):
            out = self.kernel(*args, dt, steps, **self.kwargs)
        with _metrics.phase("advection.flat.write_back"):
            return self.write_back(state, out)


class _XlaFlatRun:
    """One of the flat XLA forms (``"ml"``, ``"sharded"``): its
    ``run(state, steps, dt)``, per-slot voxel ``shape`` and z ``ring``
    (``HaloExtend``)."""

    def __init__(self, run, shape):
        self.run = run
        self.shape = tuple(shape)
        self.ring = run.ring


class Advection:
    #: the reference's cell (density, velocity, flux, max_diff; lengths
    #: live in the geometry instead of per-cell storage)
    SPEC = {
        "density": ((), np.float64),
        "vx": ((), np.float64),
        "vy": ((), np.float64),
        "vz": ((), np.float64),
        "flux": ((), np.float64),
        "max_diff": ((), np.float64),
    }

    def __init__(self, grid, hood_id=None, dtype=np.float64, use_kernels=True,
                 allow_dense=True, overlap=False, allow_boxed=True):
        self.grid = grid
        self.hood_id = hood_id
        self.dtype = numpy_dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.use_kernels = bool(use_kernels)
        self.allow_boxed = bool(allow_boxed)
        self.device = grid.device
        self.spec = {k: (s, self.dtype) for k, (s, _) in self.SPEC.items()}
        #: the boxed layout and its run, built on first use (``boxed``,
        #: ``_boxed_run``); ``_UNBUILT`` until then, None without one
        self._boxed = None
        self._boxed_fn = None
        self._prefer_boxed = False
        #: split-phase stepping: ``step`` / ``run`` take the split step of the
        #: general path, which this pins (no dense path, no flat run)
        self.overlap = bool(overlap)
        self.dense = grid.epoch.dense if allow_dense and not self.overlap else None
        with _metrics.phase("advection.init"):
            if self.dense is not None:
                self._init_dense()
            else:
                self._init_general()

    # ------------------------------------------------------- general path

    def _init_general(self):
        grid = self.grid
        self.tables = StencilTables(grid, self.hood_id, with_geometry=True)
        self._exchange = grid.halo(self.hood_id)
        host, self._dev = build_face_tables(grid, self.hood_id, self.tables,
                                            self.dtype)
        self.inv_volume = host["inv_volume"]
        self._local_host = grid.epoch.local_mask
        #: which flat form ``run`` takes: "pallas" (kernel B5), "ml_pallas"
        #: (kernel B6), "ml" / "sharded" (plain torch) or None — the JAX
        #: package's labels
        self._flat_kind = None
        self._flat_run = None
        if self.overlap:
            self._inner, self._outer = build_split_tables(
                grid, self.hood_id, host, self.dtype)
            self._ar = torch.arange(len(grid.slots), device=self.device)[:, None]
            return
        if self.allow_boxed:
            self._boxed = _UNBUILT
        self._flat_run = self._build_flat_run()
        # the JAX package's cost rule: boxed when the flat form's voxel
        # inflation exceeds its per-voxel rate advantage (the sharded form
        # keeps the flat preference).  The boxed volume is at least the
        # leaf count, so a flat form within ``edge`` x leaves never trades
        # and the layout is not built for the answer.
        if self._flat_kind in ("pallas", "ml", "ml_pallas") and self.allow_boxed:
            edge = (FLAT_BOXED_EDGE if self._flat_kind == "pallas"
                    else ML_BOXED_EDGE[self._flat_kind])
            if (self._flat_n_vox > edge * len(grid.epoch.leaves)
                    and self.boxed is not None):
                boxed_vol = sum(int(np.prod(b.shape))
                                for b in self.boxed.boxes.values())
                self._prefer_boxed = self._flat_n_vox > edge * boxed_vol
        # replicated host metadata decides the form: the same on every
        # controller, or no rank may step
        assert_agreement("Advection run form",
                         f"{self._flat_kind} {self._prefer_boxed}".encode())

    @property
    def boxed(self):
        """The boxed layout (``parallel/boxed.py``), built on first use;
        None on the dense or split path, with ``allow_boxed=False``, or
        where the grid has no layout."""
        if self._boxed is _UNBUILT:
            from ..parallel.boxed import build_boxed

            self._boxed = build_boxed(self.grid, self.hood_id)
        return self._boxed

    @property
    def _boxed_run(self):
        """The boxed per-level passes (``models/boxed_advection.py``) on
        :attr:`boxed`, built on first use; None without a layout."""
        if self._boxed_fn is None and self.boxed is not None:
            from .boxed_advection import build_boxed_run

            self._boxed_fn = build_boxed_run(self, self.boxed)
        return self._boxed_fn

    def _build_flat_run(self):
        """The flat whole-run form the grid qualifies for (the JAX
        package's ``_build_flat_run`` order): kernel B6 on one slot in
        float32 when it fits, else the ``ml`` pyramid form, for 3 or more
        levels; the ``sharded`` form on D > 1 slots; kernel B5 on one slot
        in float32.  None when none qualifies or kernels are off."""
        grid = self.grid
        if not self.use_kernels:
            return None
        tml = build_flat_ml_tables(grid)
        if tml is not None:
            self._flat_n_vox = int(tml["n_vox"])
            if (tml["n_devices"] == 1 and self.dtype == np.float32
                    and flat_ml_kernel_fits(self._flat_n_vox, tml["vl"])):
                self._flat_kind = "ml_pallas"
                return _FlatRun.multi_level(tml, self.device)
            self._flat_kind = "ml"
            return _XlaFlatRun(make_flat_ml_run(grid, tml, self._run_dtype()),
                               tml["shape"])
        ts = build_flat_amr_sharded(grid)
        if ts is not None:
            self._flat_n_vox = int(np.prod(ts["shape"])) * ts["n_devices"]
            self._flat_kind = "sharded"
            return _XlaFlatRun(
                make_flat_amr_run_sharded(grid, ts, self._run_dtype()),
                ts["shape"])
        if self.dtype != np.float32 or grid.n_devices != 1:
            return None
        t = build_flat_amr_tables(grid)
        if t is None:
            return None
        self._flat_n_vox = int(np.prod(t["shape"]))
        self._flat_kind = "pallas"
        return _FlatRun.two_level(t, self.device)

    def _run_dtype(self):
        """The XLA forms' dtype: float32 for a float32 model, else float64."""
        return torch.float32 if self.dtype == np.float32 else torch.float64

    def _general_step(self, state, dt):
        """One gather step (the JAX package's ``_build_step`` body): a
        density-only ghost refresh, then :func:`_face_update` on the local
        rows."""
        # ghost refresh: density only, like the reference's default
        # get_mpi_datatype (cell.hpp:46-55)
        state = {**state, **self._exchange({"density": state["density"]})}
        rho = state["density"]
        nbr = self.tables.nbr_rows
        v = tuple(state[k] for k in ("vx", "vy", "vz"))
        new = _face_update(self._dev, rho, gather_neighbors(rho, nbr), v,
                           tuple(gather_neighbors(x, nbr) for x in v), dt)
        new_rho = torch.where(self.tables.local_mask, new, rho)
        return {**state, "density": new_rho, "flux": torch.zeros_like(new_rho)}

    def _side_update(self, rho, state, t, dt):
        """:func:`_face_update` of one split side's compacted rows."""
        rows, nbr = t["rows"], t["nbr_rows"]
        v = tuple(state[k] for k in ("vx", "vy", "vz"))
        return _face_update(t, rho[self._ar, rows], gather_neighbors(rho, nbr),
                            tuple(x[self._ar, rows] for x in v),
                            tuple(gather_neighbors(x, nbr) for x in v), dt)

    def _split_step(self, state, dt):
        """The split-phase step (the JAX package's ``_build_split_step``):
        start the density halo, update the inner rows (no remote neighbor,
        so they read no payload), merge the ghosts (the wait), update the
        outer rows, then keep the merged values off the local rows
        (``where(local, out, rho2)`` also cleans the scratch row the pad
        lanes wrote).  Bitwise equal to :meth:`_general_step`: the same
        per-cell operations in the same order."""
        ex, field = self._exchange, {"density": state["density"]}
        handle = ex.start(field)
        new_i = self._side_update(state["density"], state, self._inner, dt)
        rho2 = ex.finish(field, handle)["density"]
        new_o = self._side_update(rho2, state, self._outer, dt)
        out = rho2.clone()
        out[self._ar, self._inner["rows"]] = new_i
        out[self._ar, self._outer["rows"]] = new_o
        out = torch.where(self.tables.local_mask, out, rho2)
        return {**state, "density": out, "flux": torch.zeros_like(out)}

    def _general_max_dt(self, state) -> float:
        # CFL: min over local cells of length/|v| per dim (solve.hpp:284-330)
        length = self.tables.length
        steps = torch.stack([
            length[..., 0] / state["vx"].abs(),
            length[..., 1] / state["vy"].abs(),
            length[..., 2] / state["vz"].abs(),
        ], dim=-1)
        ok = (torch.isfinite(steps) & (steps > 0)
              & self.tables.local_mask[..., None])
        best = float(torch.where(ok, steps, torch.inf).min())
        _count_reads("max_time_step", 1)
        if self.grid.controllers.multi:
            from ..utils.collectives import all_reduce

            best = float(all_reduce([best], np.minimum))
        return best

    def _general_max_diff(self, state, thr):
        """Max relative density difference to face neighbors
        (adapter.hpp:71-110) on the row layout."""
        state = {**state, **self._exchange({"density": state["density"]})}
        rho = state["density"]
        rho_n = gather_neighbors(rho, self.tables.nbr_rows)
        r_c = rho[..., None]
        diff = (r_c - rho_n).abs() / (torch.minimum(r_c, rho_n) + thr)
        zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
        diff = torch.where(self._dev["face_dir"] != 0, diff, zero)
        md = diff.amax(dim=-1)
        return {**state, "max_diff": torch.where(self.tables.local_mask, md, zero)}

    # ------------------------------------------------------ dense fast path

    def _init_dense(self):
        info = self.dense
        D, nzl, ny, nx = info.n_devices, info.nz_local, info.ny, info.nx
        #: this controller's slots (all D under one controller): dense
        #: tensors are ``[len(slots), nzl, ny, nx]``
        self._slots = slots = self.grid.slots
        l0 = self.grid.geometry.get_level_0_cell_length()
        self._dx = l0.astype(np.float64)
        self._vol = float(l0.prod())
        area = np.array([l0[1] * l0[2], l0[0] * l0[2], l0[0] * l0[1]])
        self._area = tuple(float(a) for a in area.astype(self.dtype))
        self._inv_vol = float(self.dtype.type(1.0 / self._vol))
        px, py, pz = info.periodic
        self._extend = HaloExtend(info, self.grid.controllers)

        # Face validity masks for non-periodic boundaries.  "Face i" along
        # a dimension sits between cell i and cell (i+1) mod n; the
        # wrapping face is invalid unless that dimension is periodic.
        mask_x = np.ones(nx)
        mask_y = np.ones(ny)
        if not px:
            mask_x[-1] = 0.0
        if not py:
            mask_y[-1] = 0.0
        # z-face validity per (slot, local plane); the face below plane g
        # is the face above plane g-1; this controller keeps its slots' rows
        zface_up = np.ones((D, nzl))
        if not pz:
            zface_up[-1, -1] = 0.0
        zface_dn = np.roll(zface_up.reshape(-1), 1).reshape(D, nzl)
        put = lambda a: torch.tensor(a, dtype=self.torch_dtype, device=self.device)
        self._mx, self._my = put(mask_x), put(mask_y)
        self._mz_up = put(zface_up[slots.start:slots.stop])
        self._mz_dn = put(zface_dn[slots.start:slots.stop])

        #: which per-step path engaged: ("blocked_direct", B) / ("plane",)
        #: / ("xla",) — the JAX package's labels
        self.dense_kind = ("xla",)
        if self.use_kernels and self.dtype == np.float32:
            block = pick_step_block(nzl, ny, nx)
            if block >= 2:
                self.dense_kind = ("blocked_direct", block)
            elif flux_update_fits(ny, nx):
                self.dense_kind = ("plane",)
        self.fused = (self.dense_kind[0] != "xla" and D == 1
                      and fused_run_fits(nzl, ny, nx))

    def _scalar(self, v) -> float:
        return float(self.dtype.type(v))

    def _blocked_step(self, rho, vx, vy, vz, v_lo, v_hi, dt, members=False):
        r_lo, r_hi = self._extend.planes(rho, members)
        return flux_update_blocked(
            rho, r_lo, r_hi, vx, vy, vz, v_lo, v_hi, self._mx, self._my,
            self._mz_up, self._mz_dn, dt, block=self.dense_kind[1],
            area=self._area, inv_vol=self._inv_vol,
        )

    def _step_density(self, rho, vx, vy, vz, dt, members=False):
        """One dense step of the density.  With ``members`` the fields are
        member stacks ``[W, D, nzl, ny, nx]`` and ``dt`` a ``[W]`` tensor:
        the step kernels take them in one launch (each member on its own
        slab ring), the plain body broadcasts ``dt`` per member."""
        kind = self.dense_kind[0]
        if kind == "blocked_direct":
            v_lo, v_hi = self._extend.planes(vz, members)
            return self._blocked_step(rho, vx, vy, vz, v_lo, v_hi, dt, members)
        rho_e = self._extend(rho, members)
        vz_e = self._extend(vz, members)
        if kind == "plane":
            return flux_update(
                rho_e, vx, vy, vz_e, self._mx, self._my, self._mz_up,
                self._mz_dn, dt, area=self._area, inv_vol=self._inv_vol,
            )
        D, nzl = len(self._slots), self.dense.nz_local
        if members:
            dt = dt.view(-1, 1, 1, 1, 1)
        return dense_step_arith(
            rho, rho_e[..., :-2, :, :], rho_e[..., 2:, :, :], vx, vy, vz,
            vz_e[..., :-2, :, :], vz_e[..., 2:, :, :], self._mx,
            self._my.reshape(-1, 1), self._mz_up.reshape(D, nzl, 1, 1),
            self._mz_dn.reshape(D, nzl, 1, 1), dt, self._area, self._inv_vol,
        )

    def _dense_coords(self, ids):
        """(slot, local z, y, x) of given cell ids in the dense layout (the
        global slot; this controller's block starts at ``slots.start``)."""
        ids = np.asarray(ids, dtype=np.uint64)
        i = self.dense
        lin = (ids - np.uint64(1)).astype(np.int64)
        x = lin % i.nx
        y = (lin // i.nx) % i.ny
        z = lin // (i.nx * i.ny)
        return z // i.nz_local, z % i.nz_local, y, x

    def _dense_to_rows(self, state):
        """Dense ``[D, nzl, ny, nx]`` state -> the general ``[D, R]`` row
        layout of the current epoch (per field, on the host)."""
        grid = self.grid
        cells = grid.get_cells()
        row_state = grid.new_state(self.spec)
        for name in self.spec:
            vals = self.get_cell_data(state, name, cells)
            row_state = grid.set_cell_data(row_state, name, cells, vals)
        return row_state

    # ----------------------------------------------------------- user API

    def initialize_state(self):
        """Rotating-hump initial condition (initialize.hpp:36-80): solid-body
        rotation about the domain center, cosine density hump."""
        with _metrics.phase("advection.initialize_state"):
            grid = self.grid
            cells = grid.get_cells()
            centers = grid.geometry.get_center(cells)
            vx = -centers[:, 1] + 0.5
            vy = centers[:, 0] - 0.5
            vz = np.zeros(len(cells))
            radius = 0.15
            r = np.minimum(
                np.sqrt((centers[:, 0] - 0.25) ** 2 + (centers[:, 1] - 0.5) ** 2), radius
            ) / radius
            rho = 0.25 * (1 + np.cos(np.pi * r))
            values = {"density": rho, "vx": vx, "vy": vy, "vz": vz}

            if self.dense is None:
                state = grid.new_state(self.spec)
                for name in ("vx", "vy", "vz", "density"):
                    state = grid.set_cell_data(state, name, cells, values[name])
                # ghosts need velocities once (the reference transfers all data
                # at init); densities refresh every step
                return self._exchange(state)

            i = self.dense
            shape = (len(self._slots), i.nz_local, i.ny, i.nx)
            mine, (d, zl, y, x) = self._local_coords(cells)
            state = {}
            for name in self.spec:
                host = np.zeros(shape, dtype=self.dtype)
                vals = values.get(name)
                if vals is not None:
                    host[d, zl, y, x] = vals[mine]
                state[name] = torch.from_numpy(host).to(self.device)
            return state

    def _local_coords(self, ids):
        """Which of ``ids`` lie in this controller's slots, and their
        (local slot, local z, y, x)."""
        d, zl, y, x = self._dense_coords(ids)
        lo, hi = self._slots.start, self._slots.stop
        mine = (d >= lo) & (d < hi)
        return mine, (d[mine] - lo, zl[mine], y[mine], x[mine])

    def get_cell_data(self, state, field: str, ids):
        """Host-side per-cell read (dense or row layout); a collective under
        several controllers (every controller gets every value)."""
        if self.dense is None:
            return self.grid.get_cell_data(state, field, ids)
        from ..utils.collectives import fetch

        d, zl, y, x = self._dense_coords(ids)
        return fetch(state[field])[d, zl, y, x]

    def set_cell_data(self, state, field: str, ids, values):
        """Host-side per-cell write; returns a new state.  Under several
        controllers every controller is given every value and keeps its
        slots'."""
        with _metrics.phase("advection.set_cell_data"):
            if self.dense is None:
                return self.grid.set_cell_data(state, field, ids, values)
            mine, (d, zl, y, x) = self._local_coords(ids)
            host = state[field].cpu().numpy().copy()
            vals = np.broadcast_to(np.asarray(values, dtype=host.dtype), mine.shape)
            host[d, zl, y, x] = vals[mine]
            return {**state, field: torch.from_numpy(host).to(self.device)}

    def step(self, state, dt):
        with _metrics.phase("advection.step"):
            if self.dense is None:
                if self.overlap:
                    return self._split_step(state, self._scalar(dt))
                return self._general_step(state, self._scalar(dt))
            new_rho = self._step_density(
                state["density"], state["vx"], state["vy"], state["vz"],
                self._scalar(dt),
            )
            return {**state, "density": new_rho}

    # ---------------------------------------------------- cohort batching

    def _wide_spec(self):
        """The exchange-amortized step split (the JAX package's
        ``_wide_spec``): one full-depth default-hood density exchange funds
        ``budget`` interior steps.  Stencil relevance is ``"face"``; ghost
        velocities stay valid (``initialize_state`` ends with a full-state
        exchange and the velocity fields are static), so density staleness
        alone meters the budget.  The wide face tables price each
        (neighbor, direction) once (``build_face_tables``).  None on the
        dense path, with ``DCCRG_ENSEMBLE_WIDE=0`` or a budget under 2."""
        from ..parallel.halo import MemberExchange, ring_args
        from ..parallel.wide_halo import get_wide_plan, wide_enabled

        if not wide_enabled() or self.dense is not None:
            return None
        cached = getattr(self, "_wide_cached", None)
        if cached is not None and cached[0] is self.grid.epoch:
            return cached[1]
        grid = self.grid
        plan = get_wide_plan(grid, self.hood_id, relevance="face")
        spec = None
        if plan.budget >= 2:
            from ..parallel.exec_cache import WideStepSpec

            wex = grid.halo(None)
            _, wdev = build_face_tables(
                grid, self.hood_id, self.tables, self.dtype,
                hood_arrays=(plan.nbr_offset, plan.nbr_len, plan.nbr_rows,
                             plan.nbr_valid))
            put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                                device=self.device).to(dt)
            wt = {f"w.{k}": v for k, v in wdev.items()}
            wt["w.nbr_rows"] = put(grid.slot_view(plan.nbr_rows), torch.int64)
            wt["w.steps_ok"] = put(grid.slot_view(plan.steps_ok), torch.int32)
            wt.update(ring_args(wex, ["density"]))

            def bind(args, wargs, W):
                mex = MemberExchange(wex, wargs, W)
                t = {k[2:]: v for k, v in wargs.items() if k.startswith("w.")}

                def exchange(state):
                    return {**state, **mex({"density": state["density"]})}

                def interior(state, dts, j):
                    rho = state["density"]
                    nbr = t["nbr_rows"]
                    v = tuple(state[k] for k in ("vx", "vy", "vz"))
                    new = _face_update(
                        t, rho, gather_neighbors(rho, nbr, members=True), v,
                        tuple(gather_neighbors(x, nbr, members=True) for x in v),
                        dts.view(-1, 1, 1, 1))
                    # live rows: stencil inputs still exact at interior step
                    # j; owned rows equal the exchange-every-step step
                    new_rho = torch.where(t["steps_ok"] > j, new, rho)
                    return {**state, "density": new_rho,
                            "flux": torch.zeros_like(new_rho)}

                return exchange, interior

            spec = WideStepSpec(bind=bind, budget=plan.budget, args=wt,
                                local_mask=grid.slot_view(plan.local_mask))
        self._wide_cached = (grid.epoch, spec)
        return spec

    def batch_step_spec(self):
        """This model's step in cohort form (the JAX package's
        ``batch_step_spec``): the dense path (``advection.dense``: kernels
        B2 / B3 with a member axis, one launch a step for all members, or
        the plain body in float64), the split-phase step
        (``advection.split``) and the gather step (``advection``), their
        tables as member arguments.  ``steps_per_dispatch`` is
        ``DCCRG_ENSEMBLE_K``."""
        from ..parallel.exec_cache import (BatchStepSpec, args_key,
                                           default_steps_per_dispatch)
        from ..parallel.halo import MemberExchange, ring_args

        k = default_steps_per_dispatch()
        dtype = np.dtype(self.dtype)
        if self.dense is not None:
            i = self.dense
            key = ("advection.dense", i.n_devices, i.nz_local, i.ny, i.nx,
                   tuple(i.periodic), str(dtype), self.dense_kind,
                   tuple(self._dx.tolist()))

            def bind_dense(args, W):
                def body(state, dts):
                    new = self._step_density(
                        state["density"], state["vx"], state["vy"],
                        state["vz"], dts, members=True)
                    return {**state, "density": new}
                return body

            return BatchStepSpec(kind="advection.dense", kernel_key=key,
                                 bind=bind_dense, args={}, dt_dtype=dtype,
                                 steps_per_dispatch=k)
        wide = self._wide_spec()
        ex = self._exchange
        v_names = ("vx", "vy", "vz")
        if self.overlap:
            args = {f"inner.{n}": v for n, v in self._inner.items()}
            args.update({f"outer.{n}": v for n, v in self._outer.items()})
            args["local_mask"] = self.tables.local_mask
            args.update(ring_args(ex, ["density"]))

            def bind_split(args, W):
                mex = MemberExchange(ex, args, W)
                sides = [{n[len(p):]: v for n, v in args.items() if n.startswith(p)}
                         for p in ("inner.", "outer.")]

                def side(rho, state, t, dt):
                    v = tuple(state[n] for n in v_names)
                    nbr = t["nbr_rows"]
                    return _face_update(
                        t, member_rows(rho, t["rows"]),
                        gather_neighbors(rho, nbr, members=True),
                        tuple(member_rows(x, t["rows"]) for x in v),
                        tuple(gather_neighbors(x, nbr, members=True) for x in v), dt)

                def body(state, dts):
                    dt = dts.view(-1, 1, 1, 1)
                    field = {"density": state["density"]}
                    payload = mex.start(field)
                    new_i = side(state["density"], state, sides[0], dt)
                    rho2 = mex.finish(field, payload)["density"]
                    new_o = side(rho2, state, sides[1], dt)
                    out = rho2.clone()
                    for t, new in ((sides[0], new_i), (sides[1], new_o)):
                        out[(*member_index(out, t["rows"].dim()), t["rows"])] = new
                    out = torch.where(args["local_mask"], out, rho2)
                    return {**state, "density": out, "flux": torch.zeros_like(out)}
                return body

            return BatchStepSpec(
                kind="advection.split",
                kernel_key=("advection.split_step", str(dtype), args_key(args)),
                bind=bind_split, args=args, dt_dtype=dtype,
                steps_per_dispatch=k, wide=wide)
        args = dict(self._dev)
        args["nbr_rows"] = self.tables.nbr_rows
        args["local_mask"] = self.tables.local_mask
        args.update(ring_args(ex, ["density"]))

        def bind_gather(args, W):
            mex = MemberExchange(ex, args, W)

            def body(state, dts):
                state = {**state, **mex({"density": state["density"]})}
                rho = state["density"]
                nbr = args["nbr_rows"]
                v = tuple(state[n] for n in v_names)
                new = _face_update(
                    args, rho, gather_neighbors(rho, nbr, members=True), v,
                    tuple(gather_neighbors(x, nbr, members=True) for x in v),
                    dts.view(-1, 1, 1, 1))
                new_rho = torch.where(args["local_mask"], new, rho)
                return {**state, "density": new_rho,
                        "flux": torch.zeros_like(new_rho)}
            return body

        return BatchStepSpec(
            kind="advection",
            kernel_key=("advection.step", str(dtype), args_key(args)),
            bind=bind_gather, args=args, dt_dtype=dtype,
            steps_per_dispatch=k, wide=wide)

    def _record_run(self, path: str, steps, state) -> None:
        """Post-run reconciliation (``obs.fused``), the JAX package's
        series: one record a ``run`` of ``steps x schedule bytes``, the
        ghost payload the host seam would have moved for the same steps
        (the whole-run kernels keep it on the device).  Paths: ``fused``,
        ``dense``, ``boxed``, ``flat``, ``split`` and ``general``."""
        if not self.grid.telemetry.enabled:
            return
        with _metrics.phase("advection.record"):
            try:
                bps = self.grid.halo(None).bytes_moved(
                    {"density": state["density"]}
                )
            except Exception:  # noqa: BLE001 — telemetry must never raise
                bps = 0
            fused.record_run("advection", path, steps, bps)

    def _run_path(self) -> str:
        """The path ``run`` takes, by ``_record_run``'s name."""
        if self.dense is not None:
            return "fused" if self.fused else "dense"
        if self._prefer_boxed:
            return "boxed"
        if self._flat_run is not None:
            return "flat"
        return "split" if self.overlap else "general"

    def run(self, state, steps: int, dt):
        """Advance ``steps`` timesteps.  Dense: one whole-run kernel launch
        on one device when the block fits, else one step launch per step
        (the velocity halo planes hoisted out of the loop on the blocked
        path).  Refined: the boxed passes when preferred (``_prefer_boxed``),
        else the flat form the grid qualifies for (``_flat_kind``; one
        kernel launch for ``"pallas"`` / ``"ml_pallas"``), else the gather
        step (the split step with ``overlap``) per step."""
        steps, dt = int(steps), self._scalar(dt)
        path = self._run_path()
        with _metrics.phase("advection.run", _RUN_ARGS[path]):
            self._record_run(path, steps, state)
            return self._run(path, state, steps, dt)

    def _run(self, path: str, state, steps: int, dt: float):
        """:meth:`run`'s body on ``path``."""
        if path == "boxed":
            return self._boxed_run(state, steps, dt)
        if path == "flat":
            return self._flat_run.run(state, steps, dt)
        if self.dense is None:
            step = self._split_step if self.overlap else self._general_step
            for _ in range(steps):
                state = step(state, dt)
            return state
        rho, vx, vy, vz = (state[k] for k in ("density", "vx", "vy", "vz"))
        if path == "fused":
            new = fused_run(
                rho[0], vx[0], vy[0], vz[0], self._mx, self._my,
                self._mz_up[0], self._mz_dn[0], dt, steps,
                area=self._area, inv_vol=self._inv_vol,
            )
            return {**state, "density": new[None]}
        if self.dense_kind[0] == "blocked_direct":
            v_lo, v_hi = self._extend.planes(vz)
            for _ in range(steps):
                rho = self._blocked_step(rho, vx, vy, vz, v_lo, v_hi, dt)
            return {**state, "density": rho}
        for _ in range(steps):
            rho = self._step_density(rho, vx, vy, vz, dt)
        return {**state, "density": rho}

    def max_time_step(self, state) -> float:
        """CFL limit: min over cells of cell length / |v| per dimension
        (solve.hpp:284-330)."""
        with _metrics.phase("advection.max_time_step"):
            if self.dense is None:
                return self._general_max_dt(state)
            return self._dense_max_dt(state)

    def _dense_max_dt(self, state) -> float:
        """:meth:`max_time_step` on the dense layout: a host-to-device copy
        of the cell length and a blocking read a dimension."""
        best = float("inf")
        for axis, name in enumerate(("vx", "vy", "vz")):
            v = state[name]
            s = torch.tensor(self._dx[axis], dtype=v.dtype, device=v.device) / v.abs()
            s = torch.where(torch.isfinite(s) & (s > 0), s, torch.inf)
            best = min(best, float(s.min()))
        v = state["vx"]
        _count_reads("max_time_step", 3, copies=3, nbytes=3 * v.element_size())
        if self.grid.controllers.multi:
            from ..utils.collectives import all_reduce

            best = float(all_reduce([best], np.minimum))
        return best

    def compute_max_diff(self, state, diff_threshold: float):
        """AMR refinement indicator (adapter.hpp:71-110): max relative
        density difference to the face neighbors, open-boundary faces
        masked out, on whichever layout the model runs."""
        thr = self._scalar(diff_threshold)
        if self.dense is None:
            return self._general_max_diff(state, thr)
        rho = state["density"]
        D, nzl = len(self._slots), self.dense.nz_local

        def rel(a, b):
            return torch.abs(a - b) / (torch.minimum(a, b) + thr)

        mxp, myp = self._mx, self._my.reshape(-1, 1)
        mxn, myn = torch.roll(mxp, 1, 0), torch.roll(myp, 1, 0)
        rho_e = self._extend(rho)
        md = rel(rho, torch.roll(rho, -1, 3)) * mxp
        md = torch.maximum(md, rel(rho, torch.roll(rho, 1, 3)) * mxn)
        md = torch.maximum(md, rel(rho, torch.roll(rho, -1, 2)) * myp)
        md = torch.maximum(md, rel(rho, torch.roll(rho, 1, 2)) * myn)
        md = torch.maximum(
            md, rel(rho, rho_e[:, 2:]) * self._mz_up.reshape(D, nzl, 1, 1))
        md = torch.maximum(
            md, rel(rho, rho_e[:, :-2]) * self._mz_dn.reshape(D, nzl, 1, 1))
        return {**state, "max_diff": md}

    # --------------------------------------------------------- AMR driver

    def check_for_adaptation(
        self,
        state,
        diff_increase: float = 0.025,
        diff_threshold: float = 0.25,
        unrefine_sensitivity: float = 0.5,
    ):
        """The reference's adaptation criterion (adapter.hpp:47-178): refine
        where the max relative density difference to face neighbors exceeds
        (level+1)*diff_increase, unrefine where it falls below
        unrefine_sensitivity times that; queues requests on the grid."""
        grid = self.grid
        if grid.mapping.max_refinement_level == 0:
            return state
        state = self.compute_max_diff(state, diff_threshold)
        cells = grid.get_cells()
        md = self.get_cell_data(state, "max_diff", cells)
        lvl = grid.mapping.get_refinement_level(cells)
        refine_diff = (lvl + 1) * diff_increase
        unrefine_diff = unrefine_sensitivity * refine_diff
        grid.refine_completely_many(cells[md > refine_diff])
        hold = (md <= refine_diff) & (md >= unrefine_diff)
        grid.dont_unrefine_many(cells[hold & (lvl > 0)])
        grid.unrefine_completely_many(cells[(md < unrefine_diff) & (lvl > 0)])
        return state

    def adapt_grid(self, state):
        """Commit queued adaptation and carry the state over: children
        inherit the parent's density, new parents average their children
        (adapter.hpp:230-292); velocities are re-derived from the rotation
        field at the new cell centers (adapter.hpp:300-310).  Returns ``(a
        new Advection bound to the new grid structure, the remapped state,
        new cells, removed cells)``.  From a dense grid this is its first
        refine: the state moves to the row layout first."""
        grid = self.grid
        if self.dense is not None:
            # decide from every controller's queues (the JAX package's
            # advection.py:1532-1545; the identity under one controller)
            from ..utils.collectives import sync_adaptation

            sync_adaptation(grid.amr)
            if not (grid.amr.to_refine or grid.amr.to_unrefine):
                # nothing queued: the grid stays uniform and this model
                # stays valid
                new_cells = grid.stop_refining(presynced=True)
                return self, state, new_cells, grid.get_removed_cells()
            # the dense layout is about to stop existing: convert to the
            # row layout remap_state speaks while the old epoch is current
            state = self._dense_to_rows(state)
        new_cells = grid.stop_refining(presynced=self.dense is not None)
        removed = grid.get_removed_cells()
        state = grid.remap_state(
            state,
            policy={
                "density": {"refine": "inherit", "unrefine": "mean"},
                "flux": {"refine": "zero", "unrefine": "zero"},
                "max_diff": {"refine": "zero", "unrefine": "zero"},
            },
        )
        adv = Advection(grid, self.hood_id, self.dtype,
                        use_kernels=self.use_kernels, allow_dense=False,
                        overlap=self.overlap, allow_boxed=self.allow_boxed)
        cells = grid.get_cells()
        centers = grid.geometry.get_center(cells)
        state = grid.set_cell_data(state, "vx", cells, -centers[:, 1] + 0.5)
        state = grid.set_cell_data(state, "vy", cells, centers[:, 0] - 0.5)
        state = grid.set_cell_data(state, "vz", cells, np.zeros(len(cells)))
        state = adv._exchange(state)
        return adv, state, new_cells, removed

    def total_mass(self, state) -> float:
        if self.dense is None:
            # every slot's rows, whatever the controllers (a collective)
            from ..utils.collectives import fetch

            rho = fetch(state["density"])
            vol = 1.0 / np.where(self.inv_volume > 0, self.inv_volume, np.inf)
            return float((rho * vol * self._local_host).sum())
        # every slot in the one-controller order (a collective), so the
        # sum is the same bits whatever the controllers
        from ..utils.collectives import fetch

        return float(fetch(state["density"]).astype(np.float64).sum() * self._vol)
