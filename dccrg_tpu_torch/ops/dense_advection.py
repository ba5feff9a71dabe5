"""Dense advection step kernels (CUDA) and their plain PyTorch twins.

Three hand-written kernels (``csrc/dense_advection.cu``) carry the dense
upwind advection path, one for each Pallas kernel of the JAX package's
``ops/dense_advection.py``:

==========================  ===========================================
wrapper                     replaces
==========================  ===========================================
:func:`fused_run`           ``make_fused_run`` (a whole run, one launch)
:func:`flux_update_blocked` ``make_flux_update_blocked_direct`` (a step)
:func:`flux_update`         ``make_flux_update`` (a step)
==========================  ===========================================

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain twin (``*_plain``) only for CPU tensors.  A twin repeats its kernel's
arithmetic in the same order, so the two agree bitwise on the card.  Launch
counts are kept in :data:`LAUNCHES`, twin calls in :data:`PLAIN_CALLS` (the
package-wide counters of ``ops/__init__.py``, re-exported here).

Float32 only, as in the JAX package; the f64 path is the plain step body
(:func:`dense_step_arith`) in ``models/advection.py``.

The dispatch thresholds (``fused_run_fits``, ``pick_step_block``,
``flux_update_fits``) are copied from the JAX package unchanged, so both
packages pick the same kernel on every configuration.  They model the
TPU's on-chip memory, not this card's; retuning them is queued.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import LAUNCHES, PLAIN_CALLS, reset_counts
from .resident import card_limits, cuts, run_threads

__all__ = [
    "LAUNCHES",
    "PLAIN_CALLS",
    "reset_counts",
    "fused_run_fits",
    "FusedRunPlan",
    "fused_run_plan",
    "pick_step_block",
    "flux_update_fits",
    "dense_step_arith",
    "fused_run",
    "fused_run_plain",
    "flux_update_blocked",
    "flux_update_blocked_plain",
    "flux_update",
    "flux_update_plain",
]



# ----------------------------------------------- dispatch thresholds (copied)

_FUSED_VMEM_BUDGET = 72 * 1024 * 1024
_FUSED_ARRAYS = 17
_STEP_PLANE_ARRAYS = 30
_STEP_VMEM_BUDGET = 100 * 1024 * 1024


def fused_run_fits(nzl: int, ny: int, nx: int) -> bool:
    """Whether the whole-block run kernel takes this block (the JAX
    package's resident-set rule)."""
    return _FUSED_ARRAYS * nzl * ny * nx * 4 <= _FUSED_VMEM_BUDGET


def pick_step_block(nzl: int, ny: int, nx: int) -> int:
    """Largest z-block size B (a divisor of nzl, >=2) the blocked step
    kernel takes; 0 if none does (the JAX package's rule)."""
    plane = ny * nx * 4
    for b in (16, 8, 4, 2):
        if nzl % b == 0 and (16 * b + 16) * plane <= _STEP_VMEM_BUDGET:
            return b
    return 0


def flux_update_fits(ny: int, nx: int) -> bool:
    """Whether the plane step kernel takes these x/y extents."""
    return _STEP_PLANE_ARRAYS * ny * nx * 4 <= _FUSED_VMEM_BUDGET


# ------------------------------------------------------------ launch plans

#: boundary cells a thread of :func:`fused_run`'s kernel exchanges a step at
#: most (``kSlots`` in ``csrc/dense_advection.cu``)
HALO_SLOTS = 8


@dataclass(frozen=True)
class FusedRunPlan:
    """How :func:`fused_run`'s kernel holds a ``[nzl, ny, nx]`` block on
    chip: ``parts = (pz, py, px)`` bricks, one CTA of ``threads = (bx, by)``
    each, ``tile`` the largest brick ``(tz, ty, tx)``, ``smem_bytes`` the
    dynamic shared memory a CTA, ``face_floats`` one face slot of the
    global face buffer (2 x ctas x 6 slots)."""

    parts: tuple
    tile: tuple
    ctas: int
    threads: tuple
    smem_bytes: int
    face_floats: int


def fused_smem_bytes(tile, split) -> int:
    """Shared memory of a brick ``tile = (tz, ty, tx)`` whose axes are
    ``split = (z, y, x)`` (cut into more than one part): two densities
    (ping-pong, f32) with a one-cell halo on split axes, the three weights
    (f32) and the select byte with a halo on the minus side of split
    axes."""
    tz, ty, tx = tile
    sz, sy, sx = (int(bool(s)) for s in split)
    n_a = (tz + 2 * sz) * (ty + 2 * sy) * (tx + 2 * sx)
    n_v = (tz + sz) * (ty + sy) * (tx + sx)
    return 8 * n_a + 13 * n_v


def fused_halo_cells(tile, split) -> int:
    """Halo cells a brick ``tile = (tz, ty, tx)`` reads from its neighbours
    a step: two planes on each split axis."""
    tz, ty, tx = tile
    sz, sy, sx = (bool(s) for s in split)
    return 2 * (sx * tz * ty + sy * tz * tx + sz * ty * tx)


@functools.lru_cache(maxsize=256)
def fused_run_plan(nzl: int, ny: int, nx: int, sms: int,
                   smem_per_block: int) -> FusedRunPlan:
    """The cut of a ``[nzl, ny, nx]`` block into at most ``sms`` bricks
    whose largest fits ``smem_per_block`` bytes (and whose halo its threads
    fill in :data:`HALO_SLOTS` cells each): the one that needs the
    least shared memory a CTA (the least work a CTA and, at equal memory,
    the widest x rows, then the fewest CTAs).  Raises ``ValueError`` where
    no cut fits."""
    best, least = None, None
    for pz, py, px in cuts((nzl, ny, nx), sms):
        tile = (-(-nzl // pz), -(-ny // py), -(-nx // px))
        split = (pz > 1, py > 1, px > 1)
        smem = fused_smem_bytes(tile, split)
        least = smem if least is None else min(least, smem)
        key = (smem, -tile[2], pz * py * px)
        fits = (smem <= smem_per_block and fused_halo_cells(tile, split)
                <= HALO_SLOTS * np.prod(run_threads(tile[2], tile[1])))
        if fits and (best is None or key < best[0]):
            best = (key, (pz, py, px), tile)
    if best is None:
        raise ValueError(
            f"fused_run_plan: no cut of the {nzl}x{ny}x{nx} block into at most "
            f"{sms} bricks fits {smem_per_block} bytes of shared memory a CTA "
            f"(the least any cut needs is {least})")
    (smem, _, ctas), parts, (tz, ty, tx) = best
    return FusedRunPlan(parts=parts, tile=(tz, ty, tx), ctas=ctas,
                        threads=run_threads(tx, ty), smem_bytes=smem,
                        face_floats=max(tz * ty, tz * tx, ty * tx))


# ------------------------------------------------------------ plain twins

def _f32(v) -> float:
    return float(np.float32(v))


def _face_flux(r_c, r_n, v_c, v_n, dt, area, mask):
    """Flux through the face between a cell and its + neighbor."""
    vf = (v_c + v_n) * 0.5
    return torch.where(vf >= 0, r_c, r_n) * ((dt * vf) * area) * mask


def dense_step_arith(rho, r_dn, r_up, vx, vy, vz, vz_dn, vz_up, mx, my,
                     mz_up, mz_dn, dt, area, inv_vol):
    """One dense upwind step on ``[..., nz, ny, nx]`` blocks, given the
    z-1 / z+1 neighbor values of ``rho`` and ``vz`` and face masks that
    broadcast against the block.  Accumulates in the reference's slot
    order z-, y-, x-, x+, y+, z+; every op rounds on its own."""
    ax, ay, az = area
    fx = _face_flux(rho, torch.roll(rho, -1, -1), vx, torch.roll(vx, -1, -1),
                    dt, ax, mx)
    fy = _face_flux(rho, torch.roll(rho, -1, -2), vy, torch.roll(vy, -1, -2),
                    dt, ay, my)
    fz = _face_flux(rho, r_up, vz, vz_up, dt, az, mz_up)
    fz_dn = _face_flux(r_dn, rho, vz_dn, vz, dt, az, mz_dn)
    flux = fz_dn
    flux = flux + torch.roll(fy, 1, -2)
    flux = flux + torch.roll(fx, 1, -1)
    flux = flux - fx
    flux = flux - fy
    flux = flux - fz
    return rho + flux * inv_vol


def _masks4(mx, my, mz_up, mz_dn, D, nzl):
    return (mx.reshape(-1), my.reshape(-1, 1),
            mz_up.reshape(D, nzl, 1, 1), mz_dn.reshape(D, nzl, 1, 1))


def flux_update_blocked_plain(rho, edge_lo, edge_hi, vx, vy, vz, vz_edge_lo,
                              vz_edge_hi, mx, my, mz_up, mz_dn, dt, *, block,
                              area, inv_vol):
    """Twin of :func:`flux_update_blocked`.  The z-block size ``block``
    does not change the values (every plane sees its true z neighbors, the
    device-edge planes at the ends)."""
    PLAIN_CALLS["flux_update_blocked"] += 1
    D, nzl = rho.shape[:2]
    r_dn = torch.cat([edge_lo, rho[:, :-1]], dim=1)
    r_up = torch.cat([rho[:, 1:], edge_hi], dim=1)
    v_dn = torch.cat([vz_edge_lo, vz[:, :-1]], dim=1)
    v_up = torch.cat([vz[:, 1:], vz_edge_hi], dim=1)
    return dense_step_arith(
        rho, r_dn, r_up, vx, vy, vz, v_dn, v_up,
        *_masks4(mx, my, mz_up, mz_dn, D, nzl), _f32(dt),
        tuple(_f32(a) for a in area), _f32(inv_vol),
    )


def flux_update_plain(rho_ext, vx, vy, vz_ext, mx, my, mz_up, mz_dn, dt, *,
                      area, inv_vol):
    """Twin of :func:`flux_update`."""
    PLAIN_CALLS["flux_update"] += 1
    D, nzl = vx.shape[:2]
    return dense_step_arith(
        rho_ext[:, 1:-1], rho_ext[:, :-2], rho_ext[:, 2:], vx, vy,
        vz_ext[:, 1:-1], vz_ext[:, :-2], vz_ext[:, 2:],
        *_masks4(mx, my, mz_up, mz_dn, D, nzl), _f32(dt),
        tuple(_f32(a) for a in area), _f32(inv_vol),
    )


def fused_run_plain(rho, vx, vy, vz, mx, my, mz_up, mz_dn, dt, steps, *,
                    area, inv_vol):
    """Twin of :func:`fused_run`: the face weights ``((dt*vf)*area)*mask``
    and upwind selects hoisted out of the step loop, z wrapping over the
    block (one device)."""
    PLAIN_CALLS["fused_run"] += 1
    dt, inv_vol = _f32(dt), _f32(inv_vol)
    ax, ay, az = (_f32(a) for a in area)
    nzl = rho.shape[0]
    mx, my = mx.reshape(-1), my.reshape(-1, 1)
    mzu, mzd = mz_up.reshape(nzl, 1, 1), mz_dn.reshape(nzl, 1, 1)
    vfx = (vx + torch.roll(vx, -1, 2)) * 0.5
    vfy = (vy + torch.roll(vy, -1, 1)) * 0.5
    vfz_hi = (vz + torch.roll(vz, -1, 0)) * 0.5
    vfz_lo = (torch.roll(vz, 1, 0) + vz) * 0.5
    sel_x, sel_y = vfx >= 0, vfy >= 0
    sel_zhi, sel_zlo = vfz_hi >= 0, vfz_lo >= 0
    wx = ((dt * vfx) * ax) * mx
    wy = ((dt * vfy) * ay) * my
    wzu = ((dt * vfz_hi) * az) * mzu
    wzd = ((dt * vfz_lo) * az) * mzd
    r = rho.clone()
    for _ in range(int(steps)):
        fx = torch.where(sel_x, r, torch.roll(r, -1, 2)) * wx
        fy = torch.where(sel_y, r, torch.roll(r, -1, 1)) * wy
        fz = torch.where(sel_zhi, r, torch.roll(r, -1, 0)) * wzu
        fzd = torch.where(sel_zlo, torch.roll(r, 1, 0), r) * wzd
        flux = fzd
        flux = flux + torch.roll(fy, 1, 1)
        flux = flux + torch.roll(fx, 1, 2)
        flux = flux - fx
        flux = flux - fy
        flux = flux - fz
        r = r + flux * inv_vol
    return r


# --------------------------------------------------------------- kernels

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dense_step_blocked": [_PTR] * 13 + [_INT] * 5 + [_F32] * 5 + [_PTR],
    "dense_step_plane": [_PTR] * 9 + [_INT] * 5 + [_F32] * 5 + [_PTR],
    "dense_fused_run": [_PTR] * 10 + [_INT] * 4 + [_F32] * 5 + [_INT] * 7 + [_PTR],
}
_lib = None


def _kernels():
    """The compiled ``csrc/dense_advection.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("dense_advection")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU (the twin's domain), False when
    every one is on CUDA; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA: {kinds}")


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_masks(dev, sizes, mx, my, mz_up, mz_dn) -> None:
    """Face masks: float32, contiguous, on ``dev``, with ``sizes`` =
    (nx, ny, z-mask length) elements."""
    for nm, t in (("mx", mx), ("my", my), ("mz_up", mz_up), ("mz_dn", mz_dn)):
        _check(nm, t, t.shape, dev)
    if (mx.numel(), my.numel(), mz_up.numel(), mz_dn.numel()) != (*sizes, sizes[2]):
        raise ValueError(f"mask sizes must be nx, ny, nz, nz = {(*sizes, sizes[2])}")


def _launched(which: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{which}: CUDA launch failed (cudaError_t {err})")
    LAUNCHES[which] += 1


def _consts(dt, area, inv_vol):
    return [_f32(dt), *(_f32(a) for a in area), _f32(inv_vol)]


def flux_update_blocked(rho, edge_lo, edge_hi, vx, vy, vz, vz_edge_lo,
                        vz_edge_hi, mx, my, mz_up, mz_dn, dt, *, block, area,
                        inv_vol):
    """One step over ``D`` stacked z-slab blocks, ``rho``/``vx``/``vy``/
    ``vz`` ``[D, nzl, ny, nx]``; ``edge_*`` are the ring-received planes
    ``[D, 1, ny, nx]`` below plane 0 and above plane nzl-1 of each block.
    Masks: ``mx [nx]``, ``my [ny]``, ``mz_up``/``mz_dn [D, nzl]`` (any
    shape with those elements).  ``block`` is the z-tile height (a divisor
    of nzl).  Returns the new density."""
    tensors = (rho, edge_lo, edge_hi, vx, vy, vz, vz_edge_lo, vz_edge_hi,
               mx, my, mz_up, mz_dn)
    if _on_cpu(*tensors):
        return flux_update_blocked_plain(
            *tensors, dt, block=block, area=area, inv_vol=inv_vol)
    D, nzl, ny, nx = rho.shape
    if block < 1 or nzl % block:
        raise ValueError(f"block {block} does not divide nzl {nzl}")
    dev = rho.device
    for nm, t in (("rho", rho), ("vx", vx), ("vy", vy), ("vz", vz)):
        _check(nm, t, (D, nzl, ny, nx), dev)
    for nm, t in (("edge_lo", edge_lo), ("edge_hi", edge_hi),
                  ("vz_edge_lo", vz_edge_lo), ("vz_edge_hi", vz_edge_hi)):
        _check(nm, t, (D, 1, ny, nx), dev)
    _check_masks(dev, (nx, ny, D * nzl), mx, my, mz_up, mz_dn)
    out = torch.empty_like(rho)
    err = _kernels().dense_step_blocked(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        D, nzl, ny, nx, int(block), *_consts(dt, area, inv_vol),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("flux_update_blocked", err)
    return out


#: z planes each thread of the plane kernel marches over
_PLANE_ZCHUNK = 8


def flux_update(rho_ext, vx, vy, vz_ext, mx, my, mz_up, mz_dn, dt, *, area,
                inv_vol):
    """One step from the halo-extended ``rho_ext``/``vz_ext``
    ``[D, nzl+2, ny, nx]`` (plane 0 and nzl+1 are the received halo
    planes) and ``vx``/``vy`` ``[D, nzl, ny, nx]``; masks as for
    :func:`flux_update_blocked`.  Returns the new density."""
    tensors = (rho_ext, vx, vy, vz_ext, mx, my, mz_up, mz_dn)
    if _on_cpu(*tensors):
        return flux_update_plain(*tensors, dt, area=area, inv_vol=inv_vol)
    D, nzl, ny, nx = vx.shape
    dev = vx.device
    _check("rho_ext", rho_ext, (D, nzl + 2, ny, nx), dev)
    _check("vz_ext", vz_ext, (D, nzl + 2, ny, nx), dev)
    _check("vx", vx, (D, nzl, ny, nx), dev)
    _check("vy", vy, (D, nzl, ny, nx), dev)
    _check_masks(dev, (nx, ny, D * nzl), mx, my, mz_up, mz_dn)
    out = torch.empty_like(vx)
    err = _kernels().dense_step_plane(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        D, nzl, ny, nx, min(_PLANE_ZCHUNK, nzl), *_consts(dt, area, inv_vol),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("flux_update", err)
    return out


def fused_run(rho, vx, vy, vz, mx, my, mz_up, mz_dn, dt, steps, *, area,
              inv_vol):
    """Advance one device's ``[nzl, ny, nx]`` block ``steps`` timesteps in
    one launch (z wraps over the block; non-periodic faces are masked).
    Masks: ``mx [nx]``, ``my [ny]``, ``mz_up``/``mz_dn [nzl]`` (any shape
    with those elements).  Returns the new density."""
    tensors = (rho, vx, vy, vz, mx, my, mz_up, mz_dn)
    if _on_cpu(*tensors):
        return fused_run_plain(*tensors, dt, steps, area=area, inv_vol=inv_vol)
    nzl, ny, nx = rho.shape
    dev = rho.device
    for nm, t in (("rho", rho), ("vx", vx), ("vy", vy), ("vz", vz)):
        _check(nm, t, (nzl, ny, nx), dev)
    _check_masks(dev, (nx, ny, nzl), mx, my, mz_up, mz_dn)
    steps = int(steps)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    plan = fused_run_plan(nzl, ny, nx, *card_limits(dev.index))
    out = torch.empty_like(rho)
    faces = torch.empty(2 * plan.ctas * 6 * plan.face_floats, dtype=torch.float32,
                        device=dev)
    err = _kernels().dense_fused_run(
        *(t.data_ptr() for t in tensors), out.data_ptr(), faces.data_ptr(),
        nzl, ny, nx, steps, *_consts(dt, area, inv_vol),
        *plan.parts, *plan.threads, plan.smem_bytes, plan.face_floats,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("fused_run", err)
    return out
