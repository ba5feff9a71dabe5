"""Blocked Vlasov step kernel (CUDA) and its plain PyTorch twin.

:func:`vlasov_step` replaces the JAX package's ``ops/vlasov_kernel.py::
make_vlasov_step_blocked``: one dimension-split upwind step (x, then y,
then z) of the dense phase-space array ``f [D, nzl, ny, nx, B]`` (B = nv³
velocity bins, minor) in one pass, all D slab slots in one launch
(``csrc/vlasov.cu``).  The z split's neighbour values are the x-then-y
split of the neighbouring planes, recomputed; at a slab's ends they come
from the device-edge planes ``edge_lo`` / ``edge_hi`` ``[D, 1, ny, nx, B]``
(``HaloExtend.planes`` of the raw ``f``, zeroed by the caller on an open z
boundary).  Op order and scalar association are the XLA body's
(``models/vlasov.py``), so :func:`split_xy` / :func:`split_z` also serve
the model's plain step for float64.

On CPU tensors the wrapper computes with :func:`vlasov_step_blocked_plain`;
on CUDA tensors it launches the kernel or raises.  Launches count in
``ops.LAUNCHES["vlasov_step"]``, twin calls in
``ops.PLAIN_CALLS["vlasov_step"]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..convert import numpy_dtype
from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu

__all__ = ["LAUNCHES", "PLAIN_CALLS", "pick_vlasov_block", "split_scales",
           "split_xy", "split_z", "vlasov_step", "vlasov_step_blocked_plain"]

# ----------------------------------------------- dispatch threshold (copied)

_VLASOV_VMEM_BUDGET = 100 * 1024 * 1024


def pick_vlasov_block(nzl: int, ny: int, nx: int, B: int) -> int:
    """Largest z-block size (a divisor of nzl, >= 2) whose working set
    fits the JAX package's scoped-VMEM budget; 0 if none does."""
    plane = ny * nx * B * 4
    for b in (8, 4, 2):
        if nzl % b == 0 and (7 * b + 10) * plane <= _VLASOV_VMEM_BUDGET:
            return b
    return 0


# ------------------------------------------------------------ plain twin

def split_scales(dt, inv_dx, dtype) -> tuple:
    """``dt * inv_d`` per axis, each factor cast to ``dtype`` and the
    product rounded once in it — the XLA body's ``dt * dtype(inv_dx[d])``."""
    t = numpy_dtype(dtype).type
    return tuple(float(t(dt) * t(v)) for v in inv_dx)


def _split(f, lo, hi, v, s):
    """One dimension's upwind update for all bins (the XLA body's
    ``split_dim``): ``lo`` / ``hi`` are the low / high neighbour values."""
    pos = v >= 0
    flux_hi = torch.where(pos, f, hi) * v          # at i+1/2
    flux_lo = torch.where(pos, lo, f) * v          # at i-1/2
    return f - s * (flux_hi - flux_lo)


def split_xy(f, vx, vy, sx, sy, px, py):
    """The plane-local x then y splits of ``[..., ny, nx, B]`` planes; on
    an open axis the wrapped-in neighbour is vacuum (0)."""
    lo, hi = torch.roll(f, 1, -2), torch.roll(f, -1, -2)
    if not px:
        lo[..., 0, :] = 0
        hi[..., -1, :] = 0
    f = _split(f, lo, hi, vx, sx)
    lo, hi = torch.roll(f, 1, -3), torch.roll(f, -1, -3)
    if not py:
        lo[..., 0, :, :] = 0
        hi[..., -1, :, :] = 0
    return _split(f, lo, hi, vy, sy)


def split_z(g, g_lo, g_hi, vz, sz):
    """The z split of ``g [D, nzl, ...]``, whose plane below z = 0 and
    above z = nzl-1 of each slab are ``g_lo`` / ``g_hi`` ``[D, 1, ...]``."""
    dn = torch.cat([g_lo, g[:, :-1]], dim=1)
    up = torch.cat([g[:, 1:], g_hi], dim=1)
    return _split(g, dn, up, vz, sz)


def vlasov_step_blocked_plain(f, edge_lo, edge_hi, vx, vy, vz, dt, *, block,
                              inv_dx, periodic):
    """Twin of :func:`vlasov_step` (``vlasov_kernel.py:71-107`` in torch).
    The z-block size ``block`` does not change the values."""
    PLAIN_CALLS["vlasov_step"] += 1
    sx, sy, sz = split_scales(dt, inv_dx, f.dtype)
    px, py = bool(periodic[0]), bool(periodic[1])
    xy = lambda p: split_xy(p, vx, vy, sx, sy, px, py)
    return split_z(xy(f), xy(edge_lo), xy(edge_hi), vz, sz)


# ----------------------------------------------------------------- kernel

_lib = None


def _kernels():
    """The compiled ``csrc/vlasov.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("vlasov")
        lib.vlasov_step.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                    + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.vlasov_step.restype = ctypes.c_int
        _lib = lib
    return _lib


def vlasov_step(f, edge_lo, edge_hi, vx, vy, vz, dt, *, block, inv_dx,
                periodic):
    """One step of ``f [D, nzl, ny, nx, B]`` (float32) with the device-edge
    planes ``edge_lo`` / ``edge_hi [D, 1, ny, nx, B]`` and per-bin
    velocities ``vx`` / ``vy`` / ``vz [B]``; ``block`` is the z-tile height
    (a divisor of nzl), ``inv_dx`` the inverse level-0 cell lengths and
    ``periodic`` the (x, y, ...) periodicity.  Returns the new ``f``."""
    tensors = (f, edge_lo, edge_hi, vx, vy, vz)
    if _on_cpu(*tensors):
        return vlasov_step_blocked_plain(*tensors, dt, block=block,
                                         inv_dx=inv_dx, periodic=periodic)
    if f.dim() != 5:
        raise ValueError(f"f must be [D, nzl, ny, nx, B], got {tuple(f.shape)}")
    D, nzl, ny, nx, B = f.shape
    if block < 1 or nzl % block:
        raise ValueError(f"block {block} does not divide nzl {nzl}")
    dev = f.device
    _check("f", f, (D, nzl, ny, nx, B), dev)
    _check("edge_lo", edge_lo, (D, 1, ny, nx, B), dev)
    _check("edge_hi", edge_hi, (D, 1, ny, nx, B), dev)
    for nm, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        _check(nm, t, (B,), dev)
    sx, sy, sz = split_scales(dt, inv_dx, np.float32)
    out = torch.empty_like(f)
    err = _kernels().vlasov_step(
        *(t.data_ptr() for t in tensors), out.data_ptr(), D, nzl, ny, nx, B,
        int(block), int(bool(periodic[0])), int(bool(periodic[1])), sx, sy, sz,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("vlasov_step", err)
    return out
