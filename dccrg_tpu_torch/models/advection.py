"""3-D upwind finite-volume advection — the framework's north-star workload
(reference ``tests/advection``: cell layout ``cell.hpp:36-44``, flux solver
``solve.hpp:43-260``, initial condition ``initialize.hpp:36-80``, rotating
velocity field ``solve.hpp:336-346``).

This slice ports the dense uniform-grid path of the JAX package's
``models/advection.py``: payloads are ``[D, nz_local, ny, nx]`` z-slab
tensors, every face flux is a shifted neighbor read, and the z halo is the
two ring planes of ``parallel/dense.py::HaloExtend``.  Cells accumulate
their own flux in the fixed slot order z-, y-, x-, x+, y+, z+.

Dispatch (the JAX package's, on the same thresholds): float32 with
``use_kernels`` goes through the CUDA kernels of ``ops/dense_advection.py``
— the whole-run kernel for ``run`` on one device when the block fits, the
blocked step kernel when a z-block size divides ``nz_local``, else the
plane step kernel.  Float64, or ``use_kernels=False``, runs the plain step
body (the JAX package's XLA body).  On CPU tensors each kernel wrapper
computes with its plain twin.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import numpy_dtype, torch_dtype
from ..ops.dense_advection import (
    dense_step_arith,
    flux_update,
    flux_update_blocked,
    flux_update_fits,
    fused_run,
    fused_run_fits,
    pick_step_block,
)
from ..parallel.dense import HaloExtend

__all__ = ["Advection"]


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

    def __init__(self, grid, hood_id=None, dtype=np.float64, use_kernels=True):
        self.grid = grid
        self.hood_id = hood_id
        self.dtype = numpy_dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.use_kernels = bool(use_kernels)
        self.device = grid.device
        self.spec = {k: (s, self.dtype) for k, (s, _) in self.SPEC.items()}
        self.dense = grid.epoch.dense
        if self.dense is None:
            raise NotImplementedError(
                "Advection on a refined or non-slab grid (the general gather "
                "path) is not ported yet (ROADMAP.md queue A, item 6)"
            )
        self._init_dense()

    # ------------------------------------------------------ dense fast path

    def _init_dense(self):
        info = self.dense
        D, nzl, ny, nx = info.n_devices, info.nz_local, info.ny, info.nx
        l0 = self.grid.geometry.get_level_0_cell_length()
        self._dx = l0.astype(np.float64)
        self._vol = float(l0.prod())
        area = np.array([l0[1] * l0[2], l0[0] * l0[2], l0[0] * l0[1]])
        self._area = tuple(float(a) for a in area.astype(self.dtype))
        self._inv_vol = float(self.dtype.type(1.0 / self._vol))
        px, py, pz = info.periodic
        self._extend = HaloExtend(info)

        # Face validity masks for non-periodic boundaries.  "Face i" along
        # a dimension sits between cell i and cell (i+1) mod n; the
        # wrapping face is invalid unless that dimension is periodic.
        mask_x = np.ones(nx)
        mask_y = np.ones(ny)
        if not px:
            mask_x[-1] = 0.0
        if not py:
            mask_y[-1] = 0.0
        # z-face validity per (device, local plane); the face below plane g
        # is the face above plane g-1
        zface_up = np.ones((D, nzl))
        if not pz:
            zface_up[-1, -1] = 0.0
        zface_dn = np.roll(zface_up.reshape(-1), 1).reshape(D, nzl)
        put = lambda a: torch.tensor(a, dtype=self.torch_dtype, device=self.device)
        self._mx, self._my = put(mask_x), put(mask_y)
        self._mz_up, self._mz_dn = put(zface_up), put(zface_dn)

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

    def _blocked_step(self, rho, vx, vy, vz, v_lo, v_hi, dt):
        r_lo, r_hi = self._extend.planes(rho)
        return flux_update_blocked(
            rho, r_lo, r_hi, vx, vy, vz, v_lo, v_hi, self._mx, self._my,
            self._mz_up, self._mz_dn, dt, block=self.dense_kind[1],
            area=self._area, inv_vol=self._inv_vol,
        )

    def _step_density(self, rho, vx, vy, vz, dt):
        kind = self.dense_kind[0]
        if kind == "blocked_direct":
            v_lo, v_hi = self._extend.planes(vz)
            return self._blocked_step(rho, vx, vy, vz, v_lo, v_hi, dt)
        rho_e = self._extend(rho)
        vz_e = self._extend(vz)
        if kind == "plane":
            return flux_update(
                rho_e, vx, vy, vz_e, self._mx, self._my, self._mz_up,
                self._mz_dn, dt, area=self._area, inv_vol=self._inv_vol,
            )
        D, nzl = self.dense.n_devices, self.dense.nz_local
        return dense_step_arith(
            rho, rho_e[:, :-2], rho_e[:, 2:], vx, vy, vz, vz_e[:, :-2],
            vz_e[:, 2:], self._mx, self._my.reshape(-1, 1),
            self._mz_up.reshape(D, nzl, 1, 1),
            self._mz_dn.reshape(D, nzl, 1, 1), dt, self._area, self._inv_vol,
        )

    def _dense_coords(self, ids):
        """(device, local z, y, x) of given cell ids in the dense layout."""
        ids = np.asarray(ids, dtype=np.uint64)
        i = self.dense
        lin = (ids - np.uint64(1)).astype(np.int64)
        x = lin % i.nx
        y = (lin // i.nx) % i.ny
        z = lin // (i.nx * i.ny)
        return z // i.nz_local, z % i.nz_local, y, x

    # ----------------------------------------------------------- user API

    def initialize_state(self):
        """Rotating-hump initial condition (initialize.hpp:36-80): solid-body
        rotation about the domain center, cosine density hump."""
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

        i = self.dense
        shape = (i.n_devices, i.nz_local, i.ny, i.nx)
        d, zl, y, x = self._dense_coords(cells)
        state = {}
        for name in self.spec:
            host = np.zeros(shape, dtype=self.dtype)
            vals = {"density": rho, "vx": vx, "vy": vy, "vz": vz}.get(name)
            if vals is not None:
                host[d, zl, y, x] = vals
            state[name] = torch.from_numpy(host).to(self.device)
        return state

    def get_cell_data(self, state, field: str, ids):
        """Host-side per-cell read."""
        d, zl, y, x = self._dense_coords(ids)
        return state[field].cpu().numpy()[d, zl, y, x]

    def set_cell_data(self, state, field: str, ids, values):
        """Host-side per-cell write; returns a new state."""
        d, zl, y, x = self._dense_coords(ids)
        host = state[field].cpu().numpy().copy()
        host[d, zl, y, x] = values
        return {**state, field: torch.from_numpy(host).to(self.device)}

    def step(self, state, dt):
        new_rho = self._step_density(
            state["density"], state["vx"], state["vy"], state["vz"],
            self._scalar(dt),
        )
        return {**state, "density": new_rho}

    def run(self, state, steps: int, dt):
        """Advance ``steps`` timesteps: one whole-run kernel launch on one
        device when the block fits, else one step launch per step (the
        velocity halo planes hoisted out of the loop on the blocked path)."""
        steps, dt = int(steps), self._scalar(dt)
        rho, vx, vy, vz = (state[k] for k in ("density", "vx", "vy", "vz"))
        if self.fused:
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
        best = float("inf")
        for axis, name in enumerate(("vx", "vy", "vz")):
            v = state[name]
            s = torch.tensor(self._dx[axis], dtype=v.dtype, device=v.device) / v.abs()
            s = torch.where(torch.isfinite(s) & (s > 0), s, torch.inf)
            best = min(best, float(s.min()))
        return best

    def compute_max_diff(self, state, diff_threshold: float):
        """AMR refinement indicator (adapter.hpp:71-110): max relative
        density difference to the 6 face neighbors, open-boundary faces
        masked out."""
        rho = state["density"]
        thr = self._scalar(diff_threshold)
        D, nzl = self.dense.n_devices, self.dense.nz_local

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

    def total_mass(self, state) -> float:
        return float(
            state["density"].cpu().numpy().astype(np.float64).sum() * self._vol
        )
