"""Whole-run Game of Life kernel (CUDA) and its plain PyTorch twin.

:func:`gol_run` replaces the JAX package's ``ops/gol_kernel.py::
make_gol_run``: a single-device 2-D board advanced a runtime number of
turns in one launch (``csrc/gol.cu``).  The 8-neighbour count is the
Pallas kernel's: the y+1 / y-1 bands masked on open y, then the x+1 / x-1
neighbours of the three bands masked on open x, summed in that order; the
2/3 rule is two selects.  The board is float32 0/1, as in the JAX package
(counts <= 8 are exact).  The JAX kernel's optional tile padding only
aligns TPU rolls and is bit-identical to no padding by its own contract, so
the port computes the unpadded function.

On CPU tensors the wrapper computes with :func:`gol_run_plain`; on CUDA
tensors it launches the kernel or raises.  Launches count in
``ops.LAUNCHES["gol_run"]``, twin calls in ``ops.PLAIN_CALLS["gol_run"]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu

__all__ = ["LAUNCHES", "PLAIN_CALLS", "gol_run_fits", "gol_run", "gol_run_plain",
           "gol_turn"]

# ----------------------------------------------- dispatch threshold (copied)

_GOL_VMEM_BUDGET = 96 * 1024 * 1024
_GOL_ARRAYS = 8


def gol_run_fits(ny: int, nx: int) -> bool:
    """Whether the whole-run kernel takes this board (the JAX package's
    resident-set rule, kept so both packages dispatch alike).  The CUDA
    kernel itself takes any board below 2^31 cells; boards above this rule's
    ~3.1 M cells run the dense loop in plain torch (ROADMAP P4)."""
    return _GOL_ARRAYS * ny * nx * 4 <= _GOL_VMEM_BUDGET


# ------------------------------------------------------------- plain twin

def _validity(n: int, periodic: bool, dev):
    """(hi, lo): float32 masks of the + and - neighbour along one axis —
    1 everywhere on a periodic axis, else 0 where the neighbour would wrap
    (position n-1 for +, 0 for -)."""
    hi = torch.ones(n, dtype=torch.float32, device=dev)
    lo = torch.ones(n, dtype=torch.float32, device=dev)
    if not periodic:
        hi[-1] = 0.0
        lo[0] = 0.0
    return hi, lo


def gol_turn(up, a, dn, vxh, vxl):
    """One turn of the kernel's count and rule on float32 boards
    ``[..., ny, nx]``: ``up`` / ``dn`` are the rows at y+1 / y-1, already
    masked on an open y; ``vxh`` / ``vxl`` the x validity masks.  Returns
    ``(alive', count)``."""
    c = up + dn
    for band in (up, a, dn):
        c = c + torch.roll(band, -1, -1) * vxh
        c = c + torch.roll(band, 1, -1) * vxl
    return torch.where(c == 3.0, 1.0, torch.where(c != 2.0, 0.0, a)), c


def gol_run_plain(alive, turns, periodic_x, periodic_y):
    """Twin of :func:`gol_run`: the body of ``make_gol_run``'s kernel
    (``gol_kernel.py:59-116``) on an unpadded board, turn by turn."""
    PLAIN_CALLS["gol_run"] += 1
    ny, nx = alive.shape
    vxh, vxl = _validity(nx, periodic_x, alive.device)
    vyh, vyl = (m.reshape(ny, 1) for m in _validity(ny, periodic_y, alive.device))
    a = alive.clone()
    c = torch.zeros_like(alive)
    for _ in range(int(turns)):
        a, c = gol_turn(torch.roll(a, -1, 0) * vyh, a, torch.roll(a, 1, 0) * vyl,
                        vxh, vxl)
    return a, c


# ----------------------------------------------------------------- kernel

_lib = None


def _kernels():
    """The compiled ``csrc/gol.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("gol")
        lib.gol_run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gol_run.restype = ctypes.c_int
        _lib = lib
    return _lib


def gol_run(alive, turns, periodic_x, periodic_y):
    """Advance the float32 0/1 board ``alive [ny, nx]`` ``turns`` turns in
    one launch.  Returns ``(alive', count')``, ``count'`` the neighbour
    count of the last turn (zeros for ``turns == 0``), both float32."""
    if _on_cpu(alive):
        return gol_run_plain(alive, turns, periodic_x, periodic_y)
    if alive.dim() != 2:
        raise ValueError(f"alive must be [ny, nx], got {tuple(alive.shape)}")
    ny, nx = alive.shape
    dev = alive.device
    _check("alive", alive, (ny, nx), dev)
    turns = int(turns)
    if turns < 0:
        raise ValueError("turns must be >= 0")
    out = torch.empty_like(alive)
    cnt = torch.empty_like(alive)
    scr = torch.empty_like(alive)
    err = _kernels().gol_run(
        alive.data_ptr(), out.data_ptr(), cnt.data_ptr(), scr.data_ptr(),
        ny, nx, turns, int(bool(periodic_x)), int(bool(periodic_y)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("gol_run", err)
    return out, cnt
