"""Plain reference for the advection cells.

The upwind finite-volume scheme of dccrg's ``tests/advection``
(``solve.hpp:43-260``): a face's velocity is the two cells' velocities along
its axis, each weighted by the other cell's length on that axis; its flux
carries the upwind density through the face's area, the smaller of the two
cells' faces, times ``dt``; each cell sums its faces' fluxes over its volume.
The initial state follows ``initialize.hpp:36-80``: solid-body rotation about
the domain's centre and a cosine hump of density, whose centre and radius the
seed draws.

The leaf set, each leaf's size, and the face list with the area each pair of
leaves shares, are built here from the configuration file alone: the level-0
grid, the cells that the configuration refines replaced by their 8 children,
and a map of the finest voxels to leaves whose neighbouring voxels of
different leaves are the faces.  A configuration refines by ``adapt``, the
criterion of ``adapter.hpp:47-178`` at the settings it gives, applied once to
the hump of ``initialize.hpp`` on level 0 (the initial adaptation round of
``2d.cpp`` with one level of refinement), or, in tests, by ``refine`` balls
around level-0 centres.  Plain numpy and torch; nothing of
the program under test is imported, and nothing it made is read, except the
answers the harness hands in to be judged.
"""
from __future__ import annotations

import math

import numpy as np
import torch

def hump(x, y, centre, radius):
    """The cosine hump of ``initialize.hpp``: 0.5 at ``centre`` (in x, y),
    falling to 0 at ``radius`` and 0 beyond."""
    r = np.minimum(np.hypot(x - centre[0], y - centre[1]), radius) / radius
    return 0.25 * (1.0 + np.cos(np.pi * r))


def refined(config: dict, ijk: np.ndarray) -> np.ndarray:
    """Which level-0 cells (``ijk`` in id order) the configuration refines:
    under ``adapt``, those whose largest relative density difference to a
    face neighbour, ``|a - b| / (min(a, b) + diff_threshold)`` over the
    level-0 hump, exceeds ``diff_increase`` (``adapter.hpp``'s rule at level
    0; faces across a non-periodic boundary do not count); under ``refine``,
    those whose centres lie in one of its balls."""
    n = np.asarray(config["initial_length"], dtype=np.int64)
    l0 = np.asarray(config["domain"], dtype=np.float64) / n
    sel = np.zeros(len(ijk), dtype=bool)
    if "adapt" in config:
        a = config["adapt"]
        nx, ny, nz = (int(v) for v in n)
        x = ((np.arange(nx) + 0.5) * l0[0])[None, None, :]
        y = ((np.arange(ny) + 0.5) * l0[1])[None, :, None]
        rho = np.broadcast_to(hump(x, y, a["hump"]["centre"], a["hump"]["radius"]),
                              (nz, ny, nx))
        thr = float(a["diff_threshold"])
        most = np.zeros((nz, ny, nx))
        for axis, dim in ((0, 2), (1, 1), (2, 0)):
            for shift in (1, -1):
                nb = np.roll(rho, shift, axis=dim)
                rel = np.abs(rho - nb) / (np.minimum(rho, nb) + thr)
                if not config["periodic"][axis]:
                    edge = [slice(None)] * 3
                    edge[dim] = 0 if shift == 1 else -1
                    rel[tuple(edge)] = 0.0
                np.maximum(most, rel, out=most)
        sel |= most.ravel() > float(a["diff_increase"])
    for ball in config.get("refine", ()):
        centre = (ijk + 0.5) * l0
        sel |= np.linalg.norm(centre - np.asarray(ball["centre"]), axis=1) < float(
            ball["radius"])
    return sel


class Reference:
    """The configuration's leaves, inputs, faces and scheme."""

    def __init__(self, config: dict):
        n = np.asarray(config["initial_length"], dtype=np.int64)  # (nx, ny, nz)
        levels = int(config.get("max_refinement_level", 0))
        if levels > 1:
            raise ValueError("this reference builds at most two levels")
        self.config = config
        self.n = n
        self.periodic = tuple(bool(p) for p in config["periodic"])
        self.domain = np.asarray(config["domain"], dtype=np.float64)
        self.l0 = self.domain / n
        self.dtype = np.dtype(config["dtype"])
        self.max_level = levels
        s = 1 << self.max_level
        self.fine_shape = n * s
        self.fine_len = self.l0 / s

        nx, ny, nz = (int(v) for v in n)
        n0 = nx * ny * nz
        z, y, x = np.indices((nz, ny, nx), dtype=np.int32)
        ijk = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)  # id order
        del x, y, z
        sel = refined(config, ijk) if levels else np.zeros(n0, dtype=bool)
        #: the level-0 cell ids whose refinement the configuration asks for
        self.request = (np.flatnonzero(sel) + 1).astype(np.uint64)
        if not sel.any():
            #: leaf ids, ascending (dccrg's numbering: level-0 ids 1..n0
            #: with x fastest, then each level's cells after the levels
            #: above it)
            self.ids = np.arange(1, n0 + 1, dtype=np.uint64)
            #: each leaf's lower corner and edge, in finest voxels
            self.lo = ijk * np.int32(s)
            self.size = np.full(n0, s, dtype=np.int32)
        else:
            ids = [np.flatnonzero(~sel) + 1]
            lo = [ijk[~sel] * np.int32(s)]
            size = [np.full(len(ids[0]), s, dtype=np.int32)]
            fx, fy = nx * 2, ny * 2
            for c in range(8):
                off = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1], dtype=np.int32)
                k = ijk[sel] * 2 + off
                ids.append(1 + n0 + k[:, 0] + fx * (k[:, 1] + fy * k[:, 2].astype(np.int64)))
                lo.append(k)
                size.append(np.ones(len(k), dtype=np.int32))
            ids = np.concatenate(ids)
            order = np.argsort(ids, kind="stable")
            self.ids = ids[order].astype(np.uint64)
            self.lo = np.concatenate(lo)[order]
            self.size = np.concatenate(size)[order]
        self._faces = None
        self._v = None

    # ------------------------------------------------------------ geometry

    def centres(self) -> np.ndarray:
        return (self.lo + self.size[:, None] * 0.5) * self.fine_len

    def lengths(self) -> np.ndarray:
        return self.size[:, None] * self.fine_len

    # -------------------------------------------------------------- inputs

    def inputs(self, seed: int, device="cpu") -> dict:
        """The seed's input, handed to both sides: the density, in the
        configuration's dtype, of a hump whose centre lies at a drawn angle
        and distance from the rotation axis, with a drawn radius (worked out
        on ``device``, returned on the host)."""
        hump = self.config["hump"]
        rng = np.random.default_rng(int(seed) % (1 << 64))
        theta = rng.uniform(0.0, 2.0 * math.pi)
        dist = rng.uniform(*hump["distance"])
        radius = rng.uniform(*hump["radius"])
        mid = self.domain * 0.5
        hx = mid[0] + dist * math.cos(theta)
        hy = mid[1] + dist * math.sin(theta)
        lo = torch.as_tensor(self.lo[:, :2], device=device).double()
        half = torch.as_tensor(self.size, device=device).double()[:, None] * 0.5
        c = (lo + half) * torch.as_tensor(self.fine_len[:2], device=device)
        r = torch.hypot(c[:, 0] - hx, c[:, 1] - hy).clamp_(max=radius) / radius
        rho = (0.25 * (1.0 + torch.cos(math.pi * r))).cpu().numpy()
        return {"ids": self.ids, "density": rho.astype(self.dtype)}

    def velocities(self) -> np.ndarray:
        """``[N, 3]`` solid-body rotation about the domain's centre axis
        along z (``initialize.hpp``), in the configuration's dtype: the same
        on every seed, and worked out by each side on its own."""
        if self._v is None:
            c = self.centres()
            mid = self.domain * 0.5
            self._v = np.zeros(c.shape, dtype=self.dtype)
            self._v[:, 0] = mid[1] - c[:, 1]
            self._v[:, 1] = c[:, 0] - mid[0]
        return self._v

    # --------------------------------------------------------------- faces

    def faces(self, device) -> dict:
        """The face list on ``device``: minus-side leaf ``a``, plus-side leaf
        ``b``, ``axis``, and the ``area`` they share (finest-voxel faces of
        the pair, summed)."""
        if self._faces is not None:
            return self._faces
        mx, my, mz = (int(v) for v in self.fine_shape)
        n = len(self.ids)
        owner = torch.full((mx * my * mz,), -1, dtype=torch.int64, device=device)
        lo = torch.as_tensor(self.lo, device=device).long()
        size = torch.as_tensor(self.size, device=device).long()
        for s in torch.unique(size).tolist():
            idx = torch.nonzero(size == s).flatten()
            base = lo[idx]
            for dz in range(s):
                for dy in range(s):
                    for dx in range(s):
                        flat = ((base[:, 0] + dx) + mx * ((base[:, 1] + dy)
                                + my * (base[:, 2] + dz)))
                        owner[flat] = idx
        if bool((owner < 0).any()):
            raise ValueError("the leaves do not tile the domain")
        vol = owner.view(mz, my, mx)
        area = (self.fine_len[1] * self.fine_len[2], self.fine_len[0] * self.fine_len[2],
                self.fine_len[0] * self.fine_len[1])
        parts = {"a": [], "b": [], "axis": [], "area": []}
        for axis, dim in ((0, 2), (1, 1), (2, 0)):
            nb = torch.roll(vol, -1, dims=dim)
            here = vol
            if not self.periodic[axis]:
                keep = vol.shape[dim] - 1
                here, nb = here.narrow(dim, 0, keep), nb.narrow(dim, 0, keep)
            m = here != nb
            key = here[m] * n + nb[m]
            del m
            uniq, count = torch.unique(key, return_counts=True)
            del key
            parts["a"].append(uniq // n)
            parts["b"].append(uniq % n)
            parts["axis"].append(torch.full_like(uniq, axis))
            parts["area"].append(count.double() * area[axis])
        self._faces = {k: torch.cat(v) for k, v in parts.items()}
        return self._faces

    def summary(self, device) -> dict:
        """Leaves and faces, for the work counts."""
        return {"leaves": len(self.ids), "faces": int(len(self.faces(device)["a"]))}

    # -------------------------------------------------------------- scheme

    def cfl_limit(self, dtype) -> float:
        """The CFL limit (``solve.hpp:284-330``): the least cell length over
        speed, over every leaf and axis with a nonzero speed, in ``dtype``."""
        length = torch.as_tensor(self.lengths()).to(dtype)
        v = torch.as_tensor(self.velocities()).to(dtype)
        step = length / v.abs()
        ok = torch.isfinite(step) & (step > 0)
        return float(torch.where(ok, step, torch.inf).min())

    # ------------------------------------------------------------ judgement

    def expected(self, device, rho_ins, traffic, dtype=torch.float64):
        """This scheme's ``dt`` (the CFL limit worked out here, times the
        traffic's factor) and its density after a chunk's ``k`` steps from
        each of ``rho_ins``, computed in ``dtype``, on the host."""
        cfl, k = float(traffic["cfl"]), int(traffic["k"])
        dt = cfl * self.cfl_limit(dtype)
        scheme = Scheme(self, dt, dtype, device)
        return dt, [scheme.advance(r, k).double().cpu().numpy() for r in rho_ins]

    def judge(self, outs, dts, cells, expected) -> dict:
        """What the harness compares, each against its limit:

        * ``density_gap_first``: the widest gap between the density after
          chunk 0 (the first of ``outs``) and the expected one, as a share of
          the largest expected density;
        * ``density_gap_later``: the same, widest over the later sampled
          chunks (0 where the window held one chunk), whose inputs are the
          program's own state;
        * ``dt_gap``: over every chunk, the gap between the ``dt`` in ``dts``
          and the expected one, as a share of it;
        * ``leaf_mismatch``: the ids in one leaf set and not in the other.

        ``expected`` is :meth:`expected`'s float64 answer."""
        dt_ref, refs = expected
        dt_gap = max((abs(d - dt_ref) / dt_ref for d in dts), default=0.0)
        cells = np.asarray(cells, dtype=np.uint64)
        mismatch = (0 if np.array_equal(cells, self.ids)
                    else int(np.setxor1d(cells, self.ids).size))
        gaps = [float(np.abs(np.asarray(out, np.float64) - ref).max()
                      / np.abs(ref).max())
                 for out, ref in zip(outs, refs, strict=True)]
        return {"density_gap_first": gaps[0],
                "density_gap_later": max(gaps[1:], default=0.0),
                "dt_gap": dt_gap, "leaf_mismatch": mismatch}

    def start(self, inputs: dict) -> np.ndarray:
        """Chunk 0's input, as the harness compares it: the benchmark's own
        density, in leaf order, on the host."""
        return np.asarray(inputs["density"], dtype=np.float64)

    def readings(self, device, samples, dts, cells, traffic) -> dict:
        """:meth:`judge` of the program's answers: ``samples`` are ``(density
        in, density out)`` host arrays in leaf order for the sampled chunks,
        chunk 0 first, ``dts`` every chunk's ``dt``, ``cells`` the program's
        leaf ids; the scheme runs in float64 from each sampled chunk's
        input."""
        exp = self.expected(device, [s[0] for s in samples], traffic)
        return self.judge([s[1] for s in samples], dts, cells, exp)

    def control(self, device, samples, traffic, dtype, exp=None) -> dict:
        """The readings of this scheme computed in ``dtype`` (the control: a
        precision below the configuration's) put in the program's place,
        from the same chunk inputs; ``exp`` the float64 answer, if known."""
        rho_ins = [s[0] for s in samples]
        exp = exp or self.expected(device, rho_ins, traffic)
        dt, outs = self.expected(device, rho_ins, traffic, dtype)
        return self.judge(outs, [dt], self.ids, exp)


class Scheme:
    """The scheme's per-face weights in one dtype, and its steps."""

    def __init__(self, ref: Reference, dt: float, dtype, device):
        f = ref.faces(device)
        a, b, axis = f["a"], f["b"], f["axis"]
        put = lambda x: torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)
        length = put(ref.lengths())
        v = put(ref.velocities())
        la, lb = length[a, axis], length[b, axis]
        va, vb = v[a, axis], v[b, axis]
        vf = (la * vb + lb * va) / (la + lb)
        flux = (torch.tensor(dt, dtype=dtype, device=device) * vf) * f["area"].to(dtype)
        vol = length.prod(dim=1)
        self.a, self.b = a, b
        self.up = torch.where(vf >= 0, a, b)
        self.wa = flux / vol[a]
        self.wb = flux / vol[b]
        self.dtype, self.device = dtype, device

    @torch.inference_mode()
    def advance(self, rho, steps: int):
        """``steps`` steps from the host or device density ``rho``."""
        rho = torch.as_tensor(np.asarray(rho)).to(device=self.device, dtype=self.dtype)
        for _ in range(int(steps)):
            up = rho[self.up]
            rho = rho.index_add(0, self.a, up * self.wa, alpha=-1)
            rho.index_add_(0, self.b, up * self.wb)
        return rho
