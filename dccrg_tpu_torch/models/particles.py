"""Particle-in-cell support: variable-size per-cell payloads (PyTorch).

Reference: ``tests/particles`` — each cell owns a list of particle
coordinates; ``get_mpi_datatype`` switches between transferring the count
and the coordinates (a two-phase ragged exchange,
``tests/particles/cell.hpp:50-84``, ``simple.cpp:285-294``), and particles
that leave a cell are handed to whichever cell now contains them
(``simple.cpp:52-97``).

As in the JAX package's ``models/particles.py``, the ragged lists are
padded ``[D, R, P, 3]`` coordinates plus a ``[D, R]`` count.  The push is
a tensor op; the ghost update moves the counts first and the coordinates
second through the grid's ``HaloExchange`` (kernel B9 on a multi-slot CUDA
grid).  Re-bucketing particles into their new cells stays on the device on
uniform Cartesian grids — refined, mixed-periodicity and any ownership
included: a stable sort of each slot's padded particles, keyed on the
epoch's sorted row-id tables through the cell-id algebra, claims the
particles of local and ghost rows that land in the slot's own cells.
Particles lost to a non-periodic boundary, to a cell's capacity or to a
jump past the ghost halo are counted in the state's ``overflow`` (a device
scalar).  Stretched geometries re-bucket on the host.

The JAX package runs this model in XLA, with no Pallas kernel; its ops here
are PyTorch ops on the grid's device (``argsort``, ``searchsorted``,
``scatter_add_``, ``index_put_``).

Under several controllers (``parallel/mesh.py``) a controller keeps its own
slots' rows ``[len(slots), R, ...]`` and the re-bucket's tables of them; the
two exchanges cross controllers through the grid's halo (kernel B9, the
transport, B9).  ``overflow`` holds this controller's share of the lost
count (a particle that leaves one controller's cells and lands in
another's counts +1 there and -1 here), and :meth:`lost` sums the shares
over every controller: no step waits on the host for it.  The readers
(``positions``, ``count``, ``particles_of``, ``lost``) are collectives.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import torch_dtype
from ..parallel.stencil import StencilTables
from ..utils.collectives import _gather_bytes, all_reduce, assert_agreement, fetch
from ..utils.setops import ragged_arange

__all__ = ["Particles"]


class Particles:
    def __init__(self, grid, max_particles_per_cell: int = 64, hood_id=None,
                 dtype=np.float32):
        """``dtype``: the coordinates' dtype (float32 by default, the
        bench's; the reference stores doubles, ``np.float64``)."""
        self.grid = grid
        self.P = int(max_particles_per_cell)
        self.hood_id = hood_id
        self.dtype = np.dtype(dtype)
        self._tdtype = torch_dtype(self.dtype)
        self._bind()

    def _bind(self):
        """(Re)build everything that depends on the grid's epoch."""
        self.tables = StencilTables(self.grid, self.hood_id)
        self._exchange = self.grid.halo(self.hood_id)
        self._dev_rebucket = self._build_device_rebucket()
        assert_agreement("Particles re-bucket",
                         b"device" if self._dev_rebucket is not None else b"host")

    def spec(self):
        return {
            "particles": ((self.P, 3), self.dtype),
            "number_of_particles": ((), np.int32),
        }

    # ------------------------------------------------------------ lifecycle

    def new_state(self, positions: np.ndarray):
        """Bucket given particle positions (M, 3) into their cells."""
        state = self.grid.new_state(self.spec())
        return self._scatter(state, np.asarray(positions, dtype=np.float64))

    def _scatter(self, state, positions):
        """Bucket (M, 3) positions into their cells' padded slots on the
        host: one stable sort and one scatter, input order kept within a
        cell (the reference's per-particle list appends,
        ``tests/particles/simple.cpp:52-97``).  Every controller buckets
        every position and keeps its own slots' rows."""
        grid = self.grid
        D, R = grid.n_devices, grid.epoch.R
        pos_arr = np.zeros((D, R, self.P, 3))
        cnt = np.zeros((D, R), dtype=np.int32)
        if len(positions):
            cells = grid.get_existing_cell(positions)
            if not (cells != 0).all():
                raise ValueError("particles outside the grid")
            lpos = grid.leaves.position(cells)
            dev = grid.leaves.owner[lpos].astype(np.int64)
            row = grid.epoch.row_of[lpos].astype(np.int64)
            key = dev * R + row
            cnt_flat = np.bincount(key, minlength=D * R)
            if cnt_flat.max() > self.P:
                raise ValueError(
                    f"cell capacity exceeded ({self.P} particles/cell)"
                )
            cnt = cnt_flat.reshape(D, R).astype(np.int32)
            order = np.argsort(key, kind="stable")
            slot = ragged_arange(cnt_flat[cnt_flat > 0])
            pos_arr.reshape(D * R, self.P, 3)[key[order], slot] = positions[order]
        return {
            **state,
            "particles": torch.as_tensor(grid.slot_view(pos_arr),
                                         dtype=self._tdtype, device=grid.device),
            "number_of_particles": torch.as_tensor(grid.slot_view(cnt),
                                                   device=grid.device),
        }

    # ---------------------------------------------------------------- step

    def _push(self, state, velocity, dt):
        """Move every local particle by ``velocity * dt``; ``velocity`` is a
        (3,) tensor or a per-cell ``[D, R, 3]`` field."""
        x = state["particles"]
        valid = (torch.arange(self.P, device=x.device)
                 < state["number_of_particles"][..., None])
        valid = valid & self.tables.local_mask[..., None]
        v = velocity[:, :, None, :] if velocity.dim() == 3 else velocity
        moved = x + v * dt
        return {**state, "particles": torch.where(valid[..., None], moved, x)}

    def _velocity(self, velocity):
        """The push's velocity on the device: a (3,) vector, or a per-cell
        field whose ``[D, R, 3]`` (``velocity_field``) this controller takes
        its slots of."""
        v = np.asarray(velocity, dtype=np.float64)
        if v.ndim == 3 and len(v) == self.grid.n_devices:
            v = self.grid.slot_view(v)
        return torch.as_tensor(v, dtype=self._tdtype, device=self.grid.device)

    def _advance(self, state, velocity, dt):
        """One push, the two-phase ghost update (counts, then coordinates:
        one exchange each) and the re-bucket."""
        state = self._push(state, velocity, dt)
        state = {**state, **self._exchange(
            {"number_of_particles": state["number_of_particles"]})}
        state = {**state, **self._exchange({"particles": state["particles"]})}
        return self.rebucket(state)

    def step(self, state, velocity=(0.1, 0.0, 0.0), dt: float = 1.0):
        """Push particles, refresh ghost copies (counts then coordinates —
        the reference's two-phase idiom), then hand particles to the cells
        that now contain them.  ``velocity`` is a global (3,) vector or a
        per-cell ``[D, R, 3]`` field (see ``velocity_field``)."""
        return self._advance(state, self._velocity(velocity), float(dt))

    def run(self, state, steps: int, velocity=(0.1, 0.0, 0.0),
            dt: float = 1.0):
        """``steps`` push / exchange / re-bucket cycles; on the device path
        nothing a step waits for the host (``overflow`` stays a device
        scalar)."""
        v, dt = self._velocity(velocity), float(dt)
        if self._dev_rebucket is not None and "overflow" not in state:
            state = {**state, "overflow": self._zero_overflow()}
        for _ in range(int(steps)):
            state = self._advance(state, v, dt)
        return state

    def _zero_overflow(self):
        return torch.zeros((), dtype=torch.int32, device=self.grid.device)

    # --------------------------------------------- device-side re-bucketing

    def _build_device_rebucket(self):
        """The re-bucket keyed on the epoch's leaf tables (the JAX
        package's ``_build_device_rebucket``): per slot, one stable sort of
        the padded particles keys them by target local row; ghost rows
        supply the neighbors' emigrants, so a particle may move at most the
        halo width a step (the reference's neighbor-handoff reach).

        The target cell of a position is found with the id algebra
        (``core/mapping.py``): the candidate id at every refinement level
        present is shift/add arithmetic on the max-resolution voxel triple,
        and exactly one candidate can appear in a slot's sorted row-id table.
        Returns None where the grid does not qualify (a stretched geometry,
        or ids past 2^62): the host path is the general mechanism."""
        grid = self.grid
        epoch = grid.epoch
        mapping = epoch.mapping
        if len(grid.leaves) == 0:
            return None
        if not getattr(grid.geometry, "uniform_level0", False):
            return None
        D, R = len(grid.slots), epoch.R
        # candidate ids and the dead-row sentinels past them must fit the
        # id dtype: int32 where they do (the JAX package's default), else
        # int64
        if int(mapping.last_cell) + R + 2 < 2**31:
            id_dtype = torch.int32
        elif int(mapping.last_cell) + R + 2 < 2**62:
            id_dtype = torch.int64
        else:
            return None
        dev = grid.device
        L = mapping.max_refinement_level
        geo = grid.geometry
        nx, ny, nz = (int(v) for v in mapping.length)
        start = np.asarray(geo.get_start(), np.float64)
        clen0 = np.asarray(geo.get_level_0_cell_length(), np.float64)
        dom = clen0 * np.array([nx, ny, nz], np.float64)
        vox_len = clen0 / (1 << L)
        vox_dims = np.array([nx << L, ny << L, nz << L], np.int64)
        level_offsets = mapping._level_offsets.astype(np.int64)
        # per-slot sorted row-id table: dead rows (id 0) get sentinels past
        # every real id, so they sort last and never match
        cell_ids = np.asarray(grid.slot_view(epoch.cell_ids)).astype(np.int64)
        sentinel = int(mapping.last_cell) + 1
        keyed = np.where(cell_ids == 0, sentinel + np.arange(R)[None, :], cell_ids)
        sort_order = np.argsort(keyed, axis=1)
        ids_s = torch.as_tensor(np.take_along_axis(keyed, sort_order, axis=1),
                                dtype=id_dtype, device=dev)
        rows_s = torch.as_tensor(sort_order, device=dev)
        local = self.tables.local_mask
        levels = sorted(int(v) for v in np.unique(
            mapping.get_refinement_level(grid.leaves.cells)))
        # the level candidates' constants: (shift, level offset, lx, ly)
        cand_consts = [(L - lvl, int(level_offsets[lvl]), nx << lvl, ny << lvl)
                       for lvl in levels]
        t = lambda a, dt=self._tdtype: torch.as_tensor(a, dtype=dt, device=dev)
        lo, hi, dom_t, vox_t = t(start), t(start + dom), t(dom), t(vox_len)
        vmax = t(vox_dims - 1, id_dtype)
        periodic = t(np.asarray(grid.topology.periodic, dtype=bool), torch.bool)
        P = self.P
        slot_ar = torch.arange(R * P, device=dev)
        dev_ar = torch.arange(D, device=dev)[:, None].expand(D, R * P)

        def rebucket(state):
            pos, cnt = state["particles"], state["number_of_particles"]
            valid = (torch.arange(P, device=dev) < cnt[..., None]).reshape(D, R * P)
            p = pos.reshape(D, R * P, 3)
            # the domain is closed ([start, end] per axis), as on the host:
            # a periodic axis wraps only a coordinate strictly outside, so
            # one on the upper edge stays in the last cell
            raw_in = (p >= lo) & (p <= hi)
            wrapped = lo + torch.remainder(p - lo, dom_t)
            wp = torch.where(periodic & ~raw_in, wrapped, p)
            in_dom = (periodic | raw_in).all(dim=-1)
            ivox = torch.floor((wp - lo) / vox_t).to(id_dtype)
            ivox = torch.minimum(torch.clamp(ivox, min=0), vmax)
            row = torch.zeros((D, R * P), dtype=torch.int64, device=dev)
            found = torch.zeros((D, R * P), dtype=torch.bool, device=dev)
            for s, off, lx, ly in cand_consts:
                cx, cy, cz = ivox[..., 0] >> s, ivox[..., 1] >> s, ivox[..., 2] >> s
                cand = off + cx + lx * (cy + ly * cz)
                at = torch.searchsorted(ids_s, cand).clamp_(max=R - 1)
                hit = ids_s.gather(1, at) == cand
                row = torch.where(hit & ~found, rows_s.gather(1, at), row)
                found = found | hit
            claimed = valid & in_dom & found & local.gather(1, row)
            key = torch.where(claimed, row, R)            # R: drop sentinel
            order = torch.argsort(key, dim=1, stable=True)
            ks = key.gather(1, order)
            ws = wp.gather(1, order[..., None].expand(D, R * P, 3))
            slot = slot_ar - torch.searchsorted(ks, ks, side="left")
            counts = torch.zeros((D, R + 1), dtype=torch.int32, device=dev)
            counts.scatter_add_(1, key, torch.ones_like(key, dtype=torch.int32))
            new_cnt = torch.clamp(counts[:, :R], max=P)
            # the sentinel's particles and slots past a cell's capacity land
            # on a trash row past the end (no boolean indexing, which would
            # wait for the host), and are counted below
            keep = (ks < R) & (slot < P)
            dest = torch.where(keep, (dev_ar * R + ks) * P + slot, D * R * P)
            flat = torch.zeros((D * R * P + 1, 3), dtype=pos.dtype, device=dev)
            flat.index_put_((dest.reshape(-1),), ws.reshape(-1, 3))
            new_pos = flat[:-1].view(D, R, P, 3)
            # lost = the population before (local rows: ghost rows are
            # copies) minus the population after; this controller's share
            before = (cnt * local).sum(dtype=torch.int32)
            after = new_cnt.sum(dtype=torch.int32)
            overflow = state.get("overflow")
            if overflow is None:
                overflow = self._zero_overflow()
            return {**state, "particles": new_pos, "number_of_particles": new_cnt,
                    "overflow": overflow + (before - after)}

        return rebucket

    def velocity_field(self, fn) -> np.ndarray:
        """Per-cell velocity array ``[D, R, 3]`` from a function of cell
        centers (``fn((M, 3)) -> (M, 3)``): the reference's per-cell
        velocity data (``tests/particles/simple.cpp:52-97``).  Every slot's
        rows on every controller; a step takes its own slots' block."""
        ids = np.asarray(self.grid.epoch.cell_ids)
        D, R = ids.shape
        out = np.zeros((D, R, 3))
        live = ids.ravel() != 0
        if live.any():
            centers = self.grid.geometry.get_center(ids.ravel()[live])
            out.reshape(D * R, 3)[live] = np.asarray(fn(centers))
        return out

    def rebucket(self, state):
        """Hand particles to the cells that contain them (periodic wrapping
        included): on the device where the grid qualifies, else on the
        host, which raises on a particle that left a non-periodic
        boundary."""
        if self._dev_rebucket is not None:
            return self._dev_rebucket(state)
        wrapped = self.grid.geometry.get_real_coordinate(self.positions(state))
        if np.isnan(wrapped).any():
            raise ValueError("particle left a non-periodic boundary")
        return self._scatter(state, wrapped)

    # ------------------------------------------------------------- queries

    def positions(self, state) -> np.ndarray:
        """All particles of local cells, (M, 3), in (slot, row, particle)
        order."""
        pos = fetch(state["particles"])
        cnt = fetch(state["number_of_particles"])
        local = fetch(self.tables.local_mask)
        valid = (np.arange(self.P)[None, None, :] < cnt[..., None]) & local[..., None]
        return pos[valid]

    def count(self, state) -> int:
        cnt = fetch(state["number_of_particles"])
        return int((cnt * fetch(self.tables.local_mask)).sum())

    def lost(self, state) -> int:
        """Particles lost so far (``overflow``): a non-periodic boundary, a
        cell's capacity or a jump past the halo.  Under several controllers
        the sum of every controller's share (a collective)."""
        share = int(state.get("overflow", 0))
        if not self.grid.controllers.multi:
            return share
        return int(all_reduce(np.asarray([share], np.int64)))

    def particles_of(self, state, cell) -> np.ndarray:
        """The (n, 3) coordinates of ``cell``'s particles.  Under several
        controllers a collective: the owner's controller reads them and
        every controller gets them."""
        grid = self.grid
        pos = int(grid.leaves.position(np.uint64(cell)))
        d = int(grid.leaves.owner[pos])
        r = int(grid.epoch.row_of[pos])
        if not grid.controllers.multi:
            n = int(state["number_of_particles"][d, r])
            return fetch(state["particles"][d, r, :n])
        buf = np.zeros((self.P + 1, 3), dtype=self.dtype)
        if d in grid.slots:
            ld = d - grid.slots.start
            n = int(state["number_of_particles"][ld, r])
            buf[0, 0] = n
            buf[1:1 + n] = state["particles"][ld, r, :n].cpu().numpy()
        got = _gather_bytes(buf)[int(grid.controllers.slot_owner(grid.n_devices)[d])]
        return got[1:1 + int(got[0, 0])]

    def remap(self, state):
        """Carry particles across a structural change (AMR or load
        balance): re-bucket every particle into the current grid, the
        array form of the reference shipping particle lists with their
        cells."""
        pts = self.positions(state)  # read with the old layout's tables
        self._bind()
        fresh = self.grid.new_state(self.spec())
        if "overflow" in state:
            fresh["overflow"] = state["overflow"]
        return self._scatter(fresh, pts)
