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
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu
from .resident import card_limits, run_threads

__all__ = ["LAUNCHES", "PLAIN_CALLS", "gol_run_fits", "GolRunPlan", "gol_run_plan",
           "gol_run", "gol_run_plain", "gol_turn"]

# ----------------------------------------------- dispatch threshold (copied)

_GOL_VMEM_BUDGET = 96 * 1024 * 1024
_GOL_ARRAYS = 8


def gol_run_fits(ny: int, nx: int) -> bool:
    """Whether the whole-run kernel takes this board (the JAX package's
    resident-set rule, kept so both packages dispatch alike).  The CUDA
    kernel itself takes any board below 2^31 cells; boards above this rule's
    ~3.1 M cells run the dense loop in plain torch (ROADMAP P4)."""
    return _GOL_ARRAYS * ny * nx * 4 <= _GOL_VMEM_BUDGET


# ------------------------------------------------------------- launch plan

#: turns a round of the whole-run kernel between two synchronisations of
#: its CTAs, the most a plan takes (measured on the card: PERF.md, "B4")
GOL_TURNS_PER_ROUND = 8
#: halo cells a thread of the kernel reloads after a round at most
#: (``kGolHaloSlots`` in ``csrc/gol.cu``)
GOL_HALO_SLOTS = 8


@dataclass(frozen=True)
class GolRunPlan:
    """How :func:`gol_run`'s kernel holds a ``[ny, nx]`` board on chip:
    ``parts = (py, px)`` tiles, one CTA of ``threads = (bx, by)`` each
    (``bx`` threads along a row, each on two columns; ``by`` strips of
    rows), ``tile`` the largest tile ``(ty, tx)``, ``turns_per_round`` (k) turns
    between synchronisations, each tile with a k-deep halo on split axes,
    ``smem_bytes`` the dynamic shared memory a CTA."""

    parts: tuple
    tile: tuple
    ctas: int
    threads: tuple
    smem_bytes: int
    turns_per_round: int


def gol_smem_bytes(tile, split, k: int) -> int:
    """Shared memory of a tile ``(ty, tx)`` with a ``k``-deep halo on the
    ``split = (y, x)`` axes: two f32 boards (ping-pong)."""
    h = tile[0] + 2 * k * bool(split[0])
    w = tile[1] + 2 * k * bool(split[1])
    return 8 * h * w


def gol_halo_cells(tile, split, k: int) -> int:
    """Cells of a tile's ``k``-deep halo on the ``split = (y, x)`` axes:
    what a CTA reloads from the board after a round."""
    hy, hx = (k * bool(s) for s in split)
    return 2 * hy * (tile[1] + 2 * hx) + 2 * hx * tile[0]


def _gol_plan_at(ny: int, nx: int, sms: int, smem_per_block: int, k: int):
    """The best cut of a ``[ny, nx]`` board for ``k`` turns a round (see
    :func:`gol_run_plan`), or ``None`` where none fits; with the least
    shared memory any cut needs."""
    best, least = None, None
    for py in range(1, min(ny, sms) + 1):
        if py > 1 and ny // py < k:
            break
        for px in range(1, min(nx, sms // py) + 1):
            if px > 1 and nx // px < k:
                break
            tile = (-(-ny // py), -(-nx // px))
            split = (py > 1, px > 1)
            smem = gol_smem_bytes(tile, split, k)
            least = smem if least is None else min(least, smem)
            key = (smem, -tile[1], py * px)
            h, w = (t + 2 * k * sp for t, sp in zip(tile, split))
            threads = run_threads((w + 1) // 2, h)   # a thread: two columns
            fits = (smem <= smem_per_block and gol_halo_cells(tile, split, k)
                    <= GOL_HALO_SLOTS * np.prod(threads))
            if fits and (best is None or key < best[0]):
                best = (key, (py, px), tile, threads)
    if best is None:
        return None, least
    (smem, _, ctas), parts, tile, threads = best
    return GolRunPlan(parts=parts, tile=tile, ctas=ctas, threads=threads,
                      smem_bytes=smem, turns_per_round=k), least


@functools.lru_cache(maxsize=256)
def gol_run_plan(ny: int, nx: int, sms: int, smem_per_block: int) -> GolRunPlan:
    """The cut of a ``[ny, nx]`` board into at most ``sms`` tiles, each at
    least ``k`` cells along a split axis (so a halo reaches only the
    adjacent tiles), whose largest tile and halo fit ``smem_per_block``
    bytes (and whose halo its threads reload in :data:`GOL_HALO_SLOTS`
    cells each): the one that needs the least shared memory a CTA (at equal
    memory the widest rows, then the fewest CTAs), with ``k =``
    :data:`GOL_TURNS_PER_ROUND`, or the largest smaller ``k`` that fits.
    Raises ``ValueError`` where nothing fits."""
    for k in range(GOL_TURNS_PER_ROUND, 0, -1):
        plan, least = _gol_plan_at(ny, nx, sms, smem_per_block, k)
        if plan is not None:
            return plan
    raise ValueError(
        f"gol_run_plan: no cut of the {ny}x{nx} board into at most {sms} tiles "
        f"fits {smem_per_block} bytes of shared memory a CTA (the least any cut "
        f"needs is {least})")


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
        lib.gol_run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
    plan = gol_run_plan(ny, nx, *card_limits(dev.index))
    out = torch.empty_like(alive)
    cnt = torch.empty_like(alive)
    board = torch.empty((2, ny, nx), dtype=torch.float32, device=dev)
    err = _kernels().gol_run(
        alive.data_ptr(), out.data_ptr(), cnt.data_ptr(), board.data_ptr(),
        ny, nx, turns, int(bool(periodic_x)), int(bool(periodic_y)), *plan.parts,
        plan.turns_per_round, *plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("gol_run", err)
    return out, cnt
