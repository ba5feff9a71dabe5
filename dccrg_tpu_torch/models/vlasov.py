"""Vlasiator-style Vlasov advection: a velocity-space block per spatial
cell — the payload shape of the Vlasiator space-plasma code that the
reference grid underlies (reference CREDITS:4-6).

A port of the JAX package's ``models/vlasov.py``.  It solves
df/dt + v·∇_x f = 0: each velocity bin advects through space with its own
constant velocity; the payload per cell is the flattened ``[B = nv³]``
distribution block.  Two layouts:

* dense (a uniform slab grid): ``f [D, nz_local, ny, nx, B]`` and a
  dimension-SPLIT update per step — x, then y, then z, the z halo the two
  ring planes of ``parallel/dense.py::HaloExtend``.  In float32, when a z
  block fits (``pick_vlasov_block``), each step is one launch of the CUDA
  kernel of ``ops/vlasov_kernel.py`` (its twin on CPU tensors); otherwise
  (float64, ``use_kernels=False``, no block) the plain step, the XLA body
  of the JAX package in torch.
* general (AMR or any non-slab grid): ``f [D, R, B]`` rows of the epoch
  and an UNSPLIT per-face update over the gather tables — the advection
  workload's face machinery (``build_face_tables``) with each bin's
  constant velocity as the face velocity, the ghost blocks refreshed by the
  halo exchange every step.

Under several controllers the dense ``f`` is this controller's slots,
``[len(grid.slots), nz_local, ...]``; the ring's edge planes cross the
transport (``HaloExtend``'s controller form) and the step kernel takes
them explicitly (its ring mode would wrap inside the block), for one
scenario or a cohort's member stack (every member's planes in one
transport batch).  The row layout runs its gather and split steps through
the grid's halo, their tables this controller's slots.

The two layouts differ by the O(dt) splitting error; mass is conserved
exactly on both.  Boundaries follow ``grid.topology``: periodic dimensions
wrap; open dimensions use vacuum inflow (f = 0 outside) with free outflow,
so mass decreases monotonically as phase-space density leaves the box.

``overlap=True`` forces the general row layout, even on a slab grid, and
makes ``step`` / ``run`` the split-phase step: start the f halo (kernel B9
on a side stream on CUDA), update the inner rows, which read no ghost,
wait, then update the outer rows — bitwise equal to the general step.

``batch_step_spec`` gives each layout's step in cohort form over member
stacks: ``vlasov.dense`` (``f [W, D, nzl, ny, nx, B]``, kernel B7 with a
member axis, one launch a step for all members, each on its own slab ring
and dt), ``vlasov.split`` and the gather step ``vlasov`` (``f [W, D, R,
B]``, the halo one grouped B9 gather for every member); ``_wide_spec``
their exchange-amortized split.  There is no fallback: a kernel that fails
to build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import numpy_dtype, torch_dtype
from ..obs import fused
from ..ops.vlasov_kernel import (
    member_scales,
    pick_vlasov_block,
    split_scales,
    split_xy,
    split_z,
    vlasov_step,
)
from ..parallel.dense import HaloExtend
from ..parallel.stencil import (StencilTables, gather_neighbors, member_index,
                                member_rows, ordered_sum)
from .advection import build_face_tables, build_split_tables

__all__ = ["Vlasov"]


class Vlasov:
    def __init__(self, grid, nv: int = 4, v_max: float = 1.0,
                 dtype=np.float32, use_kernels: bool = True,
                 overlap: bool = False):
        self.grid = grid
        #: split-phase stepping on the general row layout, which this forces
        #: even on slab grids (the split form overlaps the gather path's halo)
        self.overlap = bool(overlap)
        self.info = grid.epoch.dense if not self.overlap else None
        self.nv = nv
        self.v_max = float(v_max)
        self.B = nv**3
        self.dtype = numpy_dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.use_kernels = bool(use_kernels)
        self.device = grid.device
        centers = (np.arange(nv) + 0.5) / nv * 2 * v_max - v_max
        vz, vy, vx = np.meshgrid(centers, centers, centers, indexing="ij")
        #: velocity of each bin, [B, 3]
        self.v_bins = np.stack([vx.ravel(), vy.ravel(), vz.ravel()], axis=-1)
        #: [3, B] per-axis bin velocities on the device, in the model dtype
        self._vbT = torch.tensor(self.v_bins.T, dtype=self.torch_dtype,
                                 device=self.device).contiguous()
        #: z-block height of the fused step kernel (0: the plain step)
        self._fused_block = 0
        if self.info is not None:
            self._init_dense()
        else:
            self._init_general()

    def spec(self):
        return {"f": ((self.B,), self.dtype)}

    def _scalar(self, v) -> float:
        return float(self.dtype.type(v))

    # ------------------------------------------------------- dense path

    def _init_dense(self):
        info = self.info
        #: this controller's slots (all D under one controller): ``f`` is
        #: ``[len(slots), nzl, ny, nx, B]``
        self._slots = self.grid.slots
        l0 = self.grid.geometry.get_level_0_cell_length()
        self._inv_dx = (1.0 / l0).astype(np.float64)
        self._periodic = tuple(bool(p) for p in info.periodic)
        self._extend = HaloExtend(info, self.grid.controllers)
        self._vx, self._vy, self._vz = (self._vbT[d].contiguous() for d in range(3))
        if self.use_kernels and self.dtype == np.float32:
            self._fused_block = pick_vlasov_block(
                info.nz_local, info.ny, info.nx, self.B)

    def _edges(self, f, members=False):
        """The ring's received planes (below, above) of every slab, exactly
        0 below slot 0 and above slot D-1 on an open z (vacuum; the planes
        ``ops.vlasov_kernel.ring_edges`` gives), each member's own ring
        with ``members``."""
        lo, hi = self._extend.planes(f, members)
        if not self._periodic[2]:
            a = 1 if members else 0
            if self._slots.start == 0:
                lo.select(a, 0).zero_()
            if self._slots.stop == self.info.n_devices:
                hi.select(a, -1).zero_()
        return lo.contiguous(), hi.contiguous()

    def _dense_step(self, f, dt, members=False):
        """One dense step; with ``members``, ``f [W, D, ...]`` and ``dt`` a
        ``[W]`` tensor of the model dtype (kernel B7 takes every member in
        one launch)."""
        if self._fused_block:
            # one controller: the kernel reads the slab ring's edge planes
            # from f itself; several: its ring would wrap inside this
            # controller's block, so it takes the controller ring's planes
            lo, hi = ((None, None) if self._extend.controllers is None
                      else self._edges(f, members))
            return vlasov_step(
                f, lo, hi, self._vx, self._vy, self._vz, dt,
                block=self._fused_block, inv_dx=self._inv_dx,
                periodic=self._periodic)
        # the XLA body (vlasov.py:127-149): x and y split inside the slab,
        # z through the ring
        if members:
            sc = member_scales(dt, self._inv_dx, self.torch_dtype)
            sx, sy, sz = (sc[:, i].view(-1, 1, 1, 1, 1, 1) for i in range(3))
        else:
            sx, sy, sz = split_scales(dt, self._inv_dx, self.dtype)
        g = split_xy(f, self._vx, self._vy, sx, sy, *self._periodic[:2])
        lo, hi = self._edges(g, members)
        return split_z(g, lo, hi, self._vz, sz)

    # ---------------------------------------------------- general (AMR)

    def _init_general(self):
        """Row-layout Vlasov over the gather tables — an AMR spatial grid
        with one f(v) block per leaf.  Per-face semantics are the advection
        workload's (``solve.hpp:129-260`` via the shared face tables) with
        the bin's constant velocity as the face velocity."""
        grid = self.grid
        self.tables = StencilTables(grid, None, with_geometry=True)
        self._exchange = grid.halo(None)
        host, self._dev = build_face_tables(grid, None, self.tables, self.dtype)

        # open-boundary face areas per cell per axis/side: the dense path's
        # vacuum-inflow/free-outflow closure (zero incoming, full upwind
        # outgoing) — a boundary face emits no hood entry, so its outflow
        # must be priced explicitly or open boundaries degrade to walls
        epoch = grid.epoch
        mapping = epoch.mapping
        cells = epoch.leaves.cells
        idxs = mapping.get_indices(cells).astype(np.int64)
        clen = mapping.get_cell_length_in_indices(cells).astype(np.int64)
        lengths = np.asarray(grid.geometry.get_length(cells), np.float64)
        extent = (np.asarray(mapping.length, np.int64)
                  << mapping.max_refinement_level)
        D, R = epoch.n_devices, epoch.R
        bnd_pos = np.zeros((3, D, R))
        bnd_neg = np.zeros((3, D, R))
        devs, rows = epoch.global_rows(np.arange(len(cells)))
        for d3 in range(3):
            if grid.topology.is_periodic(d3):
                continue
            area = lengths[:, (d3 + 1) % 3] * lengths[:, (d3 + 2) % 3]
            hi = (idxs[:, d3] + clen) == extent[d3]
            lo = idxs[:, d3] == 0
            bnd_pos[d3][devs, rows] = np.where(hi, area, 0.0)
            bnd_neg[d3][devs, rows] = np.where(lo, area, 0.0)
        self._has_open = bool(bnd_pos.any() or bnd_neg.any())
        # this controller's slots (all of them under one controller)
        lo, hi = grid.slots.start, grid.slots.stop
        put = lambda a: torch.tensor(a[:, lo:hi], dtype=self.torch_dtype,
                                     device=self.device)
        self._dev["bnd_pos"], self._dev["bnd_neg"] = put(bnd_pos), put(bnd_neg)
        if self.overlap:
            self._inner, self._outer = build_split_tables(
                grid, None, host, self.dtype,
                extra={"bnd_pos": bnd_pos, "bnd_neg": bnd_neg})
            self._ar = torch.arange(len(grid.slots), device=self.device)[:, None]

    def _face_update(self, t, f_c, f_n, dt):
        """``f_c [..., B]`` plus its summed upwind face fluxes (the JAX
        package's general step body) with each bin's constant velocity as
        the face velocity, and the open boundary faces' outflow.  ``t``
        holds the face tables of the cells ``f_c`` (all rows, or one split
        side), ``f_n [..., K, B]`` their neighbors' blocks.  ``dt`` is a
        float, or for member stacks a tensor shaped ``[W, 1, 1, 1]``."""
        sgn = t["sign"][..., None]
        v_face = self._vbT[t["axis_idx"].long()]              # [..., K, B]
        fc = f_c[..., None, :]
        up_pos = torch.where(v_face >= 0, fc, f_n)
        up_neg = torch.where(v_face >= 0, f_n, fc)
        upwind = torch.where(sgn > 0, up_pos, up_neg)
        dt_k = dt[..., None] if isinstance(dt, torch.Tensor) else dt
        face_flux = upwind * (dt_k * v_face) * t["min_area"][..., None]
        contrib = torch.where((t["face_dir"] != 0)[..., None],
                              -sgn * face_flux, 0.0)
        total = ordered_sum(contrib, axis=-2)
        if self._has_open:
            # outgoing-only boundary faces (incoming is vacuum)
            vbT = self._vbT
            pos, neg = t["bnd_pos"], t["bnd_neg"]
            rate = sum(
                pos.select(-3, d3)[..., None] * torch.clamp(vbT[d3], min=0)
                + neg.select(-3, d3)[..., None] * torch.clamp(-vbT[d3], min=0)
                for d3 in range(3)
            )
            total = total - dt * f_c * rate
        return f_c + total * t["inv_volume"][..., None]

    def _general_step(self, f, dt):
        f = self._exchange({"f": f})["f"]
        new = self._face_update(self._dev, f, gather_neighbors(f, self.tables.nbr_rows), dt)
        return torch.where(self.tables.local_mask[..., None], new, f)

    def _split_step(self, f, dt):
        """The split-phase step (the JAX package's ``_build_split_general``):
        start the f halo, update the inner rows (no payload read), merge the
        ghosts, update the outer rows, keep the merged values off the local
        rows.  Bitwise equal to :meth:`_general_step`."""
        ex, ar = self._exchange, self._ar
        handle = ex.start({"f": f})
        t = self._inner
        new_i = self._face_update(t, f[ar, t["rows"]], gather_neighbors(f, t["nbr_rows"]), dt)
        f2 = ex.finish({"f": f}, handle)["f"]
        t = self._outer
        new_o = self._face_update(t, f2[ar, t["rows"]], gather_neighbors(f2, t["nbr_rows"]), dt)
        out = f2.clone()
        out[ar, self._inner["rows"]] = new_i
        out[ar, self._outer["rows"]] = new_o
        return torch.where(self.tables.local_mask[..., None], out, f2)

    # ----------------------------------------------------------- user API

    def initialize_state(self, thermal_v: float = 0.35):
        """A cosine density hump in space times a Maxwellian in velocity."""
        info = self.info
        grid = self.grid
        cells = grid.get_cells()
        centers = grid.geometry.get_center(cells)
        r = np.minimum(np.sqrt(((centers - 0.5) ** 2).sum(axis=1)), 0.25) / 0.25
        rho = 0.25 * (1 + np.cos(np.pi * r)) + 0.01
        maxwell = np.exp(-((self.v_bins**2).sum(axis=1)) / (2 * thermal_v**2))
        maxwell /= maxwell.sum()
        f = rho[:, None] * maxwell[None, :]

        if info is None:
            # general row layout: one [B] block per leaf row
            state = grid.new_state(self.spec())
            state = grid.set_cell_data(state, "f", cells, f)
            return grid.update_copies_of_remote_neighbors(state)

        # this controller's slots' cells (every cell under one controller)
        slots = self._slots
        shape = (len(slots), info.nz_local, info.ny, info.nx, self.B)
        host = np.zeros(shape, self.dtype)
        lin = (cells - np.uint64(1)).astype(np.int64)
        x = lin % info.nx
        y = (lin // info.nx) % info.ny
        z = lin // (info.nx * info.ny)
        d = z // info.nz_local
        mine = (d >= slots.start) & (d < slots.stop)
        host[d[mine] - slots.start, z[mine] % info.nz_local, y[mine], x[mine]] = f[mine]
        return {"f": torch.from_numpy(host).to(self.device)}

    def step(self, state, dt):
        dt = self._scalar(dt)
        if self.info is not None:
            return {**state, "f": self._dense_step(state["f"], dt)}
        if self.overlap:
            return {**state, "f": self._split_step(state["f"], dt)}
        return {**state, "f": self._general_step(state["f"], dt)}

    def run(self, state, steps: int, dt):
        """Advance ``steps`` timesteps: on the dense float32 path one
        kernel launch a step; on the row layout one halo exchange (one B9
        launch on CUDA with D > 1) a step."""
        self._record_run(
            "fused" if self._fused_block else
            "xla" if self.info is not None else
            ("split" if self.overlap else "general"),
            steps, state,
        )
        for _ in range(int(steps)):
            state = self.step(state, dt)
        return state

    def _record_run(self, path: str, steps, state) -> None:
        """Post-run reconciliation (``obs.fused``, the JAX package's series
        and path labels: ``fused`` for the step kernel, ``xla`` for the
        plain dense step).  Dense layout: each step's slab ring ships two
        [ny, nx, B] planes per slot (none on a single slot, where the wrap
        is local); general layout: the full-f halo schedule."""
        if not self.grid.telemetry.enabled:
            return
        try:
            if self.info is not None:
                D = self.grid.n_devices
                itemsize = np.dtype(self.dtype).itemsize
                bps = (
                    D * 2 * self.info.ny * self.info.nx * self.B * itemsize
                    if D > 1 else 0
                )
            else:
                bps = self.grid.halo(None).bytes_moved({"f": state["f"]})
        except Exception:  # noqa: BLE001 — telemetry must never raise
            bps = 0
        fused.record_run("vlasov", path, steps, bps)

    def max_time_step(self) -> float:
        if self.info is None:
            # the general path's update is UNSPLIT: all three dimensions'
            # donor-cell fluxes accumulate in one step, so the stability
            # bound is dt <= 1 / max_cells sum_d |v|max_d / len_d — up to
            # 3x tighter than the per-dimension bound of the split update
            lengths = np.asarray(
                self.grid.geometry.get_length(self.grid.get_cells()), np.float64)
            vmax_d = np.abs(self.v_bins).max(axis=0)       # (3,)
            courant = (vmax_d / np.maximum(lengths, 1e-300)).sum(axis=1)
            return float(1.0 / max(courant.max(), 1e-30))
        l0 = self.grid.geometry.get_level_0_cell_length()
        vmax = np.abs(self.v_bins).max()
        return float(l0.min() / max(vmax, 1e-30))

    def density(self, state) -> np.ndarray:
        """Velocity-space integral per spatial cell: ``[D, nzl, ny, nx]`` on
        the dense layout, ``[D, R]`` rows on the general layout — every
        slot, whatever the controllers (a collective under several)."""
        from ..utils.collectives import fetch

        return fetch(state["f"]).astype(np.float64).sum(axis=-1)

    def total_mass(self, state) -> float:
        if self.info is None:
            grid = self.grid
            cells = np.sort(grid.leaves.cells)
            rho = np.asarray(grid.get_cell_data(state, "f", cells),
                             np.float64).sum(axis=-1)
            vol = np.prod(grid.geometry.get_length(cells), axis=-1)
            return float((rho * vol).sum())
        l0 = self.grid.geometry.get_level_0_cell_length()
        return float(self.density(state).sum() * np.prod(l0))

    def _wide_spec(self):
        """The exchange-amortized step split (the JAX package's
        ``_wide_spec``; the advection argument, per velocity bin).  The
        open-boundary face areas are scattered to every replica row
        (``wide_halo.scatter_rows``): interior steps update live ghost rows
        too.  None on the dense layout, with ``DCCRG_ENSEMBLE_WIDE=0`` or a
        budget under 2."""
        from ..parallel.halo import MemberExchange, ring_args
        from ..parallel.wide_halo import get_wide_plan, scatter_rows, wide_enabled

        if not wide_enabled() or self.info is not None:
            return None
        cached = getattr(self, "_wide_cached", None)
        if cached is not None and cached[0] is self.grid.epoch:
            return cached[1]
        grid = self.grid
        plan = get_wide_plan(grid, None, relevance="face")
        spec = None
        if plan.budget >= 2:
            from ..parallel.exec_cache import WideStepSpec

            wex = grid.halo(None)
            _, wdev = build_face_tables(
                grid, None, self.tables, self.dtype,
                hood_arrays=(plan.nbr_offset, plan.nbr_len, plan.nbr_rows,
                             plan.nbr_valid))
            put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                                device=self.device).to(dt)
            view = grid.slot_view
            wt = {f"w.{k}": v for k, v in wdev.items()}
            wt["w.nbr_rows"] = put(view(plan.nbr_rows), torch.int64)
            wt["w.steps_ok"] = put(view(plan.steps_ok), torch.int32)
            epoch = grid.epoch
            mapping = epoch.mapping
            cells = epoch.leaves.cells
            idxs = mapping.get_indices(cells).astype(np.int64)
            clen = mapping.get_cell_length_in_indices(cells).astype(np.int64)
            lengths = np.asarray(grid.geometry.get_length(cells), np.float64)
            extent = (np.asarray(mapping.length, np.int64)
                      << mapping.max_refinement_level)
            pos, neg = [], []
            for d3 in range(3):
                pos_leaf = np.zeros(len(cells))
                neg_leaf = np.zeros(len(cells))
                if not grid.topology.is_periodic(d3):
                    area = lengths[:, (d3 + 1) % 3] * lengths[:, (d3 + 2) % 3]
                    hi = (idxs[:, d3] + clen) == extent[d3]
                    pos_leaf = np.where(hi, area, 0.0)
                    neg_leaf = np.where(idxs[:, d3] == 0, area, 0.0)
                pos.append(view(scatter_rows(epoch, pos_leaf)))
                neg.append(view(scatter_rows(epoch, neg_leaf)))
            wt["w.bnd_pos"] = put(np.stack(pos), self.torch_dtype)
            wt["w.bnd_neg"] = put(np.stack(neg), self.torch_dtype)
            wt.update(ring_args(wex, ["f"]))

            def bind(args, wargs, W):
                mex = MemberExchange(wex, wargs, W)
                t = {k[2:]: v for k, v in wargs.items() if k.startswith("w.")}

                def exchange(state):
                    return {**state, **mex({"f": state["f"]})}

                def interior(state, dts, j):
                    f = state["f"]
                    new = self._face_update(
                        t, f, gather_neighbors(f, t["nbr_rows"], members=True),
                        dts.view(-1, 1, 1, 1))
                    live = (t["steps_ok"] > j)[..., None]
                    return {**state, "f": torch.where(live, new, f)}

                return exchange, interior

            spec = WideStepSpec(bind=bind, budget=plan.budget, args=wt,
                                local_mask=view(plan.local_mask))
        self._wide_cached = (grid.epoch, spec)
        return spec

    def batch_step_spec(self):
        """Cohort-batchable step (the JAX package's ``batch_step_spec``):
        ``vlasov.dense`` (kernel B7 with a member axis, or the plain split
        step in float64), ``vlasov.split`` and the gather step ``vlasov``.
        ``nv`` rides the kernel key."""
        from ..parallel.exec_cache import (BatchStepSpec, args_key,
                                           default_steps_per_dispatch)
        from ..parallel.halo import MemberExchange, ring_args

        k = default_steps_per_dispatch()
        dtype = np.dtype(self.dtype)
        if self.info is not None:
            i = self.info
            key = ("vlasov.dense", i.n_devices, i.nz_local, i.ny, i.nx,
                   self._periodic, str(dtype), self.nv, self._fused_block,
                   tuple(self._inv_dx.tolist()))

            def bind_dense(args, W):
                def body(state, dts):
                    return {**state, "f": self._dense_step(state["f"], dts,
                                                           members=True)}
                return body

            return BatchStepSpec(kind="vlasov.dense", kernel_key=key,
                                 bind=bind_dense, args={}, dt_dtype=dtype,
                                 steps_per_dispatch=k)
        ex = self._exchange
        wide = self._wide_spec()
        if self.overlap:
            args = {f"inner.{n}": v for n, v in self._inner.items()}
            args.update({f"outer.{n}": v for n, v in self._outer.items()})
            args["local_mask"] = self.tables.local_mask
            args.update(ring_args(ex, ["f"]))

            def bind_split(args, W):
                mex = MemberExchange(ex, args, W)
                sides = [{n[len(p):]: v for n, v in args.items() if n.startswith(p)}
                         for p in ("inner.", "outer.")]

                def side(f, t, dt):
                    return self._face_update(
                        t, member_rows(f, t["rows"]),
                        gather_neighbors(f, t["nbr_rows"], members=True), dt)

                def body(state, dts):
                    dt = dts.view(-1, 1, 1, 1)
                    f = state["f"]
                    payload = mex.start({"f": f})
                    new_i = side(f, sides[0], dt)
                    f2 = mex.finish({"f": f}, payload)["f"]
                    new_o = side(f2, sides[1], dt)
                    out = f2.clone()
                    for t, new in ((sides[0], new_i), (sides[1], new_o)):
                        out[(*member_index(out, t["rows"].dim()), t["rows"])] = new
                    out = torch.where(args["local_mask"][..., None], out, f2)
                    return {**state, "f": out}
                return body

            return BatchStepSpec(
                kind="vlasov.split",
                kernel_key=("vlasov.split_step", str(dtype), self._has_open,
                            self.nv, args_key(args)),
                bind=bind_split, args=args, dt_dtype=dtype,
                steps_per_dispatch=k, wide=wide)
        args = dict(self._dev)
        args["nbr_rows"] = self.tables.nbr_rows
        args["local_mask"] = self.tables.local_mask
        args.update(ring_args(ex, ["f"]))

        def bind_gather(args, W):
            mex = MemberExchange(ex, args, W)

            def body(state, dts):
                f = mex({"f": state["f"]})["f"]
                new = self._face_update(
                    args, f, gather_neighbors(f, args["nbr_rows"], members=True),
                    dts.view(-1, 1, 1, 1))
                return {**state, "f": torch.where(args["local_mask"][..., None], new, f)}
            return body

        return BatchStepSpec(
            kind="vlasov",
            kernel_key=("vlasov.step", str(dtype), self._has_open, self.nv,
                        args_key(args)),
            bind=bind_gather, args=args, dt_dtype=dtype,
            steps_per_dispatch=k, wide=wide)
