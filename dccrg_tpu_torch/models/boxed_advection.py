"""Multi-step advection over the boxed per-level AMR layout
(``parallel/boxed.py``) — one or more slots, one dense pass per level per
step.  A port of the JAX package's ``models/boxed_advection.py``: plain
torch ops (the JAX form is XLA code, no kernel), with the JAX mesh replaced
by the port's leading slot axis.

Layout recap (see ``parallel/boxed.py``): every refinement level's leaves
live in a dense box — the tight leaf bounding box on one slot, or (several
slots) the full domain in z and the bounding box in x/y, z-slab
partitioned over the slots with one equal slab per slot.  Each slot's slab
is extended by a one-voxel ring:

* z ring: the neighbor slots' edge planes, rolled over the slot axis
  (``parallel/dense.HaloExtend``, the dense path's ring; the circular ring
  IS the periodic z wrap; with one slot it degenerates to a local wrap —
  exact when the box covers a periodic z axis, masked out otherwise);
* x/y ring: a local pad — wrap where the box covers a periodic axis, zero
  otherwise.

Every ring voxel carries ``val = use_rho ? rho : upsampled-coarse``; a
single per-axis upwind flux pass over ``val`` with combined static weights
prices same-level AND coarse|fine faces together (the 2:1 face velocity
``(2*v_fine + v_coarse)/3`` — the reference interpolation
``(cl*v_nbr + nl*v_cell)/(cl+nl)`` with ``nl == 2*cl``, solve.hpp:168-175 —
is baked into the weight).  Fine cells read their own deltas directly; the
deltas accumulated on NON-leaf voxels are exactly the coarse receivers'
mass fluxes, recovered by a parity-aligned 2x sum-pool per pair.

The z axis runs in one of two statically chosen modes:

* **local** (one slot): z is just another axis — tight extent, cross faces
  register on ring rows where they fall off the box, and pooled fluxes
  route by contiguous segments with modulo wrap, exactly like x/y;
* **slab** (several slots): full-domain extent, cut at equal per-slot
  slabs.  z-wrap mask images register at their true modulo coordinate, so
  every slot prices every face REGISTERED in its padded slab — cut and
  periodic-seam faces are priced by BOTH adjacent slots from bit-identical
  inputs.  A slot keeps only deltas landing on its interior rows and only
  pooled rows mapping into its own coarse slab interior.  Each face is thus
  delivered exactly once per receiving cell; the per-step cross-slot
  traffic is 2 rho planes per level.

Under several controllers (``parallel/mesh.py``) every controller builds the
per-level tables for all slots from the replicated layout and keeps its own
block of slots; the z ring is the controllers' slab ring (``HaloExtend``'s
controller form: the two crossing planes a level over the transport).

Velocities are loop-invariant inside a run, so all weights and upwind
selections are computed once at run start; the loop body touches only
density.  Produces the same update as the general gather path
(solve.hpp:129-260 semantics) with a different — but fixed —
floating-point association order, and the JAX package's boxed run with the
same one, op for op.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.dense import HaloExtend

__all__ = ["build_boxed_run"]


def _clip(v, lo, hi):
    return int(min(max(v, lo), hi))


def _runs(idx):
    """Split an index vector into maximal stride-1 runs -> [(start, stop)]
    half-open slices of the source array."""
    cuts = np.flatnonzero(np.diff(idx) != 1) + 1
    return [(int(p[0]), int(p[0]) + len(p)) for p in np.split(idx, cuts)]


def _route_segments(g, gm, n_valid):
    """Contiguous segments of pooled rows mapping to contiguous target
    coordinates under modulo wrap: the main in-domain block plus one
    single-row segment per wrapped edge row (a box touching but not
    covering a periodic axis wraps to the far side of the domain); either
    way each segment gets its own slice-add, so no pooled flux is ever
    dropped."""
    inside = (gm >= 0) & (gm < n_valid)
    main = (g >= 0) & (g < n_valid)
    segs = []
    if main.any():
        i0 = int(np.argmax(main))
        i1 = int(len(g) - np.argmax(main[::-1]))
        segs.append((i0, i1, int(g[i0])))
    for i in np.flatnonzero(inside & ~main):
        segs.append((int(i), int(i) + 1, int(gm[i])))
    return segs


def _pad_axis(x, dim, wrap):
    """One ring voxel on each side of ``dim``: the wrap, or zeros."""
    n = x.shape[dim]
    if wrap:
        lo, hi = x.narrow(dim, n - 1, 1), x.narrow(dim, 0, 1)
    else:
        lo = hi = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([lo, x, hi], dim=dim)


def build_boxed_run(adv, layout):
    """The ``run(state, steps, dt) -> state`` of ``adv`` (an ``Advection``
    model) over ``layout`` (a ``BoxedLayout``), its z ring as
    ``run.ring``.  Payloads are the model's ``[D, R]`` rows (this
    controller's ``[len(slots), R]``); every array below carries the slot
    axis first, this controller's slots of it."""
    dtype = np.dtype(adv.dtype)
    grid = adv.grid
    device = grid.device
    mapping = grid.mapping
    topology = grid.topology
    D = layout.n_devices
    slab_z = D > 1
    R = grid.epoch.R
    periodic = [topology.is_periodic(d) for d in range(3)]
    boxes = sorted(layout.boxes.values(), key=lambda b: b.level)
    lvl_index = {b.level: i for i, b in enumerate(boxes)}
    pair_of_fine = {pr.fine_level: pr for pr in layout.pairs}
    L = len(boxes)
    ring = HaloExtend(D, grid.controllers)
    # this controller's block of slots: k in [k0, k0 + Dl)
    k0, Dl = grid.slots.start, len(grid.slots)

    def put(a, dt=None):
        t = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return t if dt is None else t.to(dt)

    # ---------------------------------------------- per-level static tables
    consts = []      # python-side metadata per level
    statics = []     # [D, ...] tensors per level
    for b in boxes:
        lvl = b.level
        lo = b.lo.astype(np.int64)                  # (3,) x,y,z
        bz, by, bx = b.shape
        nzl = bz // D
        dims = np.array([bx, by, bz])
        n_dom = np.array(mapping.length) << lvl     # domain extent, x,y,z
        covers = [
            bool(periodic[d] and lo[d] == 0 and dims[d] == n_dom[d])
            for d in range(3)
        ]
        # how mask ring rows are filled along z: slab mode needs the
        # circularly consistent wrap whenever z is periodic (the slot
        # ring); local mode wraps only when the box covers the axis
        z_mask_wrap = periodic[2] if slab_z else covers[2]

        def pad3(arr, xy_wrap, fill=False, z_wrap=z_mask_wrap, covers=covers):
            """Ring-pad (bz, by, bx) -> (bz+2, by+2, bx+2)."""
            out = arr
            for a, cov in ((0, z_wrap), (1, xy_wrap and covers[1]),
                           (2, xy_wrap and covers[0])):
                pw = [(0, 0)] * 3
                pw[a] = (1, 1)
                if cov:
                    out = np.pad(out, pw, mode="wrap")
                else:
                    out = np.pad(out, pw, mode="constant", constant_values=fill)
            return out

        use_rho = pad3(b.leaf_mask, xy_wrap=True)
        m_same = np.stack([pad3(b.face_valid[d], xy_wrap=True)
                           for d in range(3)])
        # cross-face masks: fine-low (mask_plus at the fine voxel) and
        # fine-high (mask_minus registered at the coarse voxel p - e_d).
        # Shifts falling off the box either fold to their true modulo
        # coordinate (slab z) or stay on the ring row and are delivered by
        # the pooled wrap segments (local mode and x/y).
        m_lowf_i = np.zeros((3, bz, by, bx), dtype=bool)
        m_highf_i = np.zeros((3, bz, by, bx), dtype=bool)
        edge_planes = {}                            # d -> ring-row-0 plane
        pr = pair_of_fine.get(lvl)
        if pr is not None:
            for d in range(3):
                m_lowf_i[d] = pr.mask_plus[d]
                ax = 2 - d
                mm = pr.mask_minus[d]
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                src[ax] = slice(1, None)
                dst[ax] = slice(0, -1)
                m_highf_i[d][tuple(dst)] = mm[tuple(src)]
                edge_sl = [slice(None)] * 3
                edge_sl[ax] = 0
                edge = mm[tuple(edge_sl)]
                if not edge.any():
                    continue
                if d == 2 and slab_z:
                    # register at the true coordinate bz-1
                    assert periodic[2], "cross face below a non-periodic floor"
                    m_highf_i[d][-1] |= edge
                else:
                    edge_planes[d] = edge
        # cross-face mask ring padding along z: slab mode wrap-pads (the
        # global rings must be circularly consistent), local mode
        # constant-pads (its box-edge faces are placed on ring row 0 below;
        # a wrap pad would copy interior registrations onto the opposite
        # ring row as phantom faces)
        cross_z_wrap = z_mask_wrap if slab_z else False
        m_lowf = np.stack([
            pad3(m_lowf_i[d], xy_wrap=False, z_wrap=cross_z_wrap)
            for d in range(3)
        ])
        m_highf = np.stack([
            pad3(m_highf_i[d], xy_wrap=False, z_wrap=cross_z_wrap)
            for d in range(3)
        ])
        for d, edge in edge_planes.items():
            ax = 2 - d
            sl = [slice(1, 1 + bz), slice(1, 1 + by), slice(1, 1 + bx)]
            sl[ax] = 0
            m_highf[d][tuple(sl)] = edge
        # no face may pair the last ring voxel with the (rolled) first;
        # x/y here, the z edge below (per slab)
        for m in (m_same, m_lowf, m_highf):
            for d in range(2):
                ax = 2 - d
                sl = [slice(None)] * 3
                sl[ax] = slice(-1, None)
                m[d][tuple(sl)] = False

        # z-slab stacking: slot k's padded rows are [k*nzl, k*nzl+nzl+2)
        # of the global padded array; one slot: the whole padded box.  This
        # controller's slots only
        def slab_pad(arr_g, nzl=nzl):               # padded global -> [Dl, ...]
            return np.stack([arr_g[..., k * nzl:k * nzl + nzl + 2, :, :]
                             for k in range(k0, k0 + Dl)])

        def slab_int(arr_g, nzl=nzl):               # interior global -> [Dl, ...]
            return np.stack([arr_g[..., k * nzl:(k + 1) * nzl, :, :]
                             for k in range(k0, k0 + Dl)])

        m_same_s = slab_pad(m_same)                 # [D, 3, nzl+2, by+2, bx+2]
        m_lowf_s = slab_pad(m_lowf)
        m_highf_s = slab_pad(m_highf)
        use_rho_s = slab_pad(use_rho)
        for m in (m_same_s, m_lowf_s, m_highf_s):
            m[:, :, -1] = False
        any_face_s = m_same_s | m_lowf_s | m_highf_s

        rows_s = slab_int(b.rows.reshape(bz, by, bx))
        leaf_s = slab_int(b.leaf_mask)

        # final scatter: the flat [Dl*R] row of every leaf and its flat
        # [Dl*nzl*by*bx] slab position (leaves only, no pad lanes)
        k_idx, pos = np.nonzero(leaf_s.reshape(Dl, -1))
        dst = k_idx * R + rows_s.reshape(Dl, -1)[k_idx, pos]
        src_pos = k_idx * (nzl * by * bx) + pos

        area = np.array(
            [
                b.length[1] * b.length[2],
                b.length[0] * b.length[2],
                b.length[0] * b.length[1],
            ]
        ).astype(dtype)
        consts.append(
            dict(
                covers=covers,
                area=[float(a) for a in area],
                inv_vol=float(dtype.type(1.0 / float(np.prod(b.length)))),
            )
        )
        statics.append(
            dict(
                rows=put(rows_s.reshape(Dl, -1), torch.int64),
                leaf=put(leaf_s),
                use_rho=put(use_rho_s),
                m_same=put(m_same_s),
                m_lowf=put(m_lowf_s),
                m_highf=put(m_highf_s),
                any_face=put(any_face_s),
                pool_mask=put(~use_rho_s),
                leaf_dst=put(dst, torch.int64),
                leaf_src=put(src_pos, torch.int64),
            )
        )

    # ------------------------------------------ per-pair static plumbing
    # Window segments for the coarse->fine upsample and routing segments
    # for the pooled fine->coarse fluxes.  x/y (and local-mode z) go
    # through clip/wrap segment decomposition; slab-mode z needs neither.
    pconsts = {}
    for pr in layout.pairs:
        fb = layout.boxes[pr.fine_level]
        cb = layout.boxes[pr.coarse_level]
        fi, ci = lvl_index[pr.fine_level], lvl_index[pr.coarse_level]
        lo_f = fb.lo.astype(np.int64)
        lo_c = cb.lo.astype(np.int64)
        bz, by, bx = fb.shape
        dims_f = np.array([bx, by, bz])
        cz, cy, cx = cb.shape
        dims_c = np.array([cx, cy, cz])
        nzl_f = bz // D
        nzc = cz // D
        n_c = np.array(mapping.length) << pr.coarse_level
        clo = (lo_f - 1) >> 1
        chi = ((lo_f + dims_f) >> 1) + 1
        # upsample window: per axis, maximal stride-1 runs into the
        # z-RINGED coarse slab (z + 1 shift); slab-mode z uses the whole
        # ringed slab
        win_segs = []
        for d in range(3):
            if d == 2 and slab_z:
                win_segs.append([(0, nzc + 2)])
                continue
            coords = np.arange(clo[d], chi[d])
            if periodic[d]:
                coords = coords % n_c[d]
            idx = np.clip(coords - lo_c[d], 0, dims_c[d] - 1)
            if d == 2:
                idx = idx + 1                       # into the ringed slab
            win_segs.append(_runs(idx))
        off = lo_f - 1 - 2 * clo                    # 0/1 per axis
        off_z = 1 if slab_z else int(off[2])

        def upsample(c_rz, win_segs=win_segs, off=off, off_z=off_z,
                     nzl=nzl_f, shape=(by, bx)):
            """[D, nzc+2, cy, cx] z-ringed coarse -> [D, nzl+2, by+2, bx+2]."""
            win = c_rz
            for a in range(3):
                segs = win_segs[2 - a]
                if len(segs) == 1 and segs[0] == (0, win.shape[a + 1]):
                    continue
                parts = [win.narrow(a + 1, i0, i1 - i0) for i0, i1 in segs]
                win = parts[0] if len(parts) == 1 else torch.cat(parts, a + 1)
            up = win
            for a in range(3):
                up = torch.repeat_interleave(up, 2, dim=a + 1)
            by_, bx_ = shape
            return up[
                :,
                off_z:off_z + nzl + 2,
                off[1]:off[1] + by_ + 2,
                off[0]:off[0] + bx_ + 2,
            ]

        # pooled routing: pad the ringed fine slab to global-even parity,
        # 2x sum-pool, then slice-add per cartesian combination of
        # per-axis segments (src_start, length, target_start), clipped
        # against the coarse box; slab-mode z contributes the single
        # interior crop
        go = lo_f - 1
        plo_pad = [int(go[d] & 1) for d in range(3)]
        if slab_z:
            plo_pad[2] = 1                          # slab start is even
        psz = [int(dims_f[d]) + 2 + plo_pad[d] for d in range(3)]
        psz[2] = nzl_f + 2 + plo_pad[2]
        phi_pad = [psz[d] % 2 for d in range(3)]
        npool = [(psz[d] + phi_pad[d]) // 2 for d in range(3)]
        cplo = go >> 1
        segments = []                               # per axis: (s0, len, t0)
        for d in range(3):
            if d == 2 and slab_z:
                segments.append([(1, nzc, 0)])
                continue
            g = cplo[d] + np.arange(npool[d])
            gm = g % n_c[d] if periodic[d] else g
            segs = []
            for i0, i1, gt in _route_segments(g, gm, int(n_c[d])):
                t0 = gt - int(lo_c[d])
                c0 = _clip(t0, 0, int(dims_c[d]))
                c1 = _clip(t0 + (i1 - i0), 0, int(dims_c[d]))
                if c1 > c0:
                    segs.append((i0 + c0 - t0, c1 - c0, c0))
            segments.append(segs)

        def pool_route(delta_c_pad, P_src, plo_pad=plo_pad, phi_pad=phi_pad,
                       segments=segments):
            """2x sum-pool the masked ring-grid deltas and add them into
            the coarse level's padded slab delta (in place; wrap images of
            the same coarse row accumulate — they carry different faces'
            fluxes)."""
            Q = F.pad(P_src, (plo_pad[0], phi_pad[0], plo_pad[1], phi_pad[1],
                              plo_pad[2], phi_pad[2]))
            for a in range(3):
                Q = (Q.narrow(a + 1, 0, Q.shape[a + 1] // 2 * 2)
                     .unflatten(a + 1, (-1, 2)))
                Q = Q.select(a + 2, 0) + Q.select(a + 2, 1)
            for z0, lz, tz in segments[2]:
                for y0, ly, ty in segments[1]:
                    for x0, lx, tx in segments[0]:
                        delta_c_pad[:, 1 + tz:1 + tz + lz,
                                    1 + ty:1 + ty + ly,
                                    1 + tx:1 + tx + lx] += \
                            Q[:, z0:z0 + lz, y0:y0 + ly, x0:x0 + lx]
            return delta_c_pad

        pconsts[fi] = dict(ci=ci, upsample=upsample, pool_route=pool_route)

    # ----------------------------------------------------------- the body
    def zring(x):
        """[D, nz_loc, ...] -> [D, nz_loc+2, ...]: the neighbor slots'
        edge planes over the circular slot ring (one slot: local wrap)."""
        below, above = ring.planes(x)
        return torch.cat([below, x, above], dim=1)

    def pad_xy(x, covers):
        """[D, nz+2, by, bx] -> [D, nz+2, by+2, bx+2]."""
        x = _pad_axis(x, 2, covers[1])
        return _pad_axis(x, 3, covers[0])

    shapes = [(Dl,) + tuple(s["leaf"].shape[1:]) for s in statics]

    def to_slab(flat, li):
        st = statics[li]
        vals = torch.gather(flat, 1, st["rows"]).reshape(shapes[li])
        return torch.where(st["leaf"], vals, torch.zeros((), dtype=vals.dtype,
                                                         device=device))

    def run(state, steps, dt):
        dt = float(dtype.type(dt))
        rho_flat = state["density"]
        v_flat = (state["vx"], state["vy"], state["vz"])
        rhos = [to_slab(rho_flat, li) for li in range(L)]
        vels = [tuple(to_slab(v, li) for v in v_flat) for li in range(L)]
        zero = torch.zeros((), dtype=rho_flat.dtype, device=device)

        # static per-level face weights and upwind selections (velocity is
        # loop-invariant; these ring exchanges run once per run)
        stat = []
        for li, c in enumerate(consts):
            C = statics[li]
            p = pconsts.get(li)
            ups = (
                [p["upsample"](zring(vels[p["ci"]][d])) for d in range(3)]
                if p is not None
                else None
            )
            per_axis = []
            for d in range(3):
                ax = 3 - d
                vv = pad_xy(zring(vels[li][d]), c["covers"])
                if ups is not None:
                    vv = torch.where(C["use_rho"], vv, ups[d])
                vl, vh = vv, torch.roll(vv, -1, ax)
                v_face = torch.where(
                    C["m_same"][:, d], 0.5 * (vl + vh),
                    torch.where(
                        C["m_lowf"][:, d], (2 * vl + vh) / 3,
                        (vl + 2 * vh) / 3,
                    ),
                )
                w = torch.where(
                    C["any_face"][:, d], dt * v_face * c["area"][d], zero
                )
                per_axis.append((v_face >= 0, w))
            stat.append(per_axis)

        for _ in range(int(steps)):
            rz = [zring(r) for r in rhos]
            deltas = []
            for li, c in enumerate(consts):
                p = pconsts.get(li)
                val = pad_xy(rz[li], c["covers"])
                if p is not None:
                    val = torch.where(
                        statics[li]["use_rho"], val,
                        p["upsample"](rz[p["ci"]]),
                    )
                delta = torch.zeros_like(val)
                for d in range(3):
                    ax = 3 - d
                    upsel, w = stat[li][d]
                    Fl = torch.where(upsel, val, torch.roll(val, -1, ax)) * w
                    delta = delta + (torch.roll(Fl, 1, ax) - Fl)
                deltas.append(delta)
            # route non-leaf voxel deltas (= coarse receivers' fluxes)
            # fine-to-coarse, finest level first
            for li in range(L - 1, -1, -1):
                p = pconsts.get(li)
                if p is None:
                    continue
                deltas[p["ci"]] = p["pool_route"](
                    deltas[p["ci"]], deltas[li] * statics[li]["pool_mask"]
                )
            rhos = [
                torch.where(
                    statics[li]["leaf"],
                    rhos[li] + deltas[li][:, 1:-1, 1:-1, 1:-1] * c["inv_vol"],
                    zero,
                )
                for li, c in enumerate(consts)
            ]

        out = rho_flat.clone().reshape(-1)
        for li in range(L):
            st = statics[li]
            out[st["leaf_dst"]] = rhos[li].reshape(-1)[st["leaf_src"]]
        return {
            **state,
            "density": out.reshape(rho_flat.shape),
            "flux": torch.zeros_like(state["flux"]),
        }

    run.ring = ring
    return run
