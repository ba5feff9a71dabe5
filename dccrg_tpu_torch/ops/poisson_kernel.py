"""Whole-solve BiCG kernel (CUDA) and its plain PyTorch twin.

:func:`bicg_solve` replaces the JAX package's ``ops/poisson_kernel.py::
make_bicg_solve``: the flat-voxel Poisson BiCG iteration (the six-roll
matvec and its transpose, the even-parity pool/broadcast of coarse rows,
three dots an iteration, and the reference's stopping rules — residual
target, ``dot_r`` breakdown, best-solution tracking with the
semi-convergence stop, ``tests/poisson/poisson_solve.hpp:246-250,
655-683``) in one launch (``csrc/poisson.cu``), float32 on one device.

Every dot is reduced in one order that depends on the shape alone
(:func:`blocked_dot`): the kernel's in-block trees and its tile partials,
written out here with elementwise adds.  The twin (:func:`bicg_solve_plain`)
uses it for its three dots, so kernel and twin agree bitwise on the card.
Both agree with the JAX package only to solver tolerance: its dots
associate as the TPU kernel or XLA reduce.

The kernel runs under a pure-Python launch plan (:func:`bicg_solve_plan`):
a CTA owns whole dot tiles for the whole solve, at most one CTA an SM.
Where each CTA's tiles form a box of voxels (a brick) the plan keeps p0,
p1 (with a one-voxel halo) and the weights in shared memory and each
thread's state and masks in registers (form ``"box"``); elsewhere (tiles
that form no box, grids too large to hold) the state stays in global
memory and is read through L2 (form ``"l2"``).  The C launcher refuses a
plan made for another shape.  Bricks of whole tiles keep the dot order,
so the plan never changes the values.

On CPU tensors the wrapper computes with the twin; on CUDA tensors it
launches the kernel or raises.  Launches count in
``ops.LAUNCHES["bicg_solve"]``, twin calls in ``ops.PLAIN_CALLS``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu
from .flat_poisson import pool_two_level, roll_apply
from .resident import card_limits

__all__ = ["BicgPlan", "bicg_fits", "bicg_solve_plan", "bricks", "blocked_sum",
           "blocked_dot", "bicg_loop", "bicg_solve", "bicg_solve_plain"]

# ----------------------------------------------- dispatch threshold (copied)

#: the JAX package's VMEM residency rule: 6 state arrays + 6 weights + rhs
#: + scaling + 4 masks + ~2 matvec temporaries, double-counted
_BICG_ARRAYS = 26
_BICG_VMEM_BUDGET = 96 * 1024 * 1024


def bicg_fits(n_voxels: int) -> bool:
    """Whether the whole-solve kernel takes this voxel count (the JAX
    package's rule, kept so both packages dispatch alike; it models the
    TPU's on-chip memory, not this card's L2)."""
    return _BICG_ARRAYS * n_voxels * 4 <= _BICG_VMEM_BUDGET


# ------------------------------------------------------ the reduction order

#: items a dot tile (the kernel's threads a block)
TILE = 256
#: tiles the kernel's second reduction level holds (TILE * 64 at most)
_MAX_TILES = TILE * 64


def _tree(v):
    """``[m, T]`` (T a power of two) -> ``[m]``: the tree that adds the
    element at stride T/2, then T/4, ..., 1 — the kernel's in-block
    reduction."""
    h = v.shape[1] // 2
    while h >= 1:
        v = v[:, :h] + v[:, h:2 * h]
        h //= 2
    return v[:, 0]


def _tile_level(v):
    m = -(-v.numel() // TILE)
    pad = m * TILE - v.numel()
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return _tree(v.reshape(m, TILE))


def blocked_sum(items):
    """Sum of a 1-D tensor in the kernel's order: trees over tiles of
    :data:`TILE` items (zeros past the end), then the same over the tile
    partials, level by level, until one value is left."""
    v = _tile_level(items)
    while v.numel() > 1:
        v = _tile_level(v)
    return v[0]


def blocked_dot(a, b, dot_m, has_coarse: bool):
    """``sum(where(dot_m != 0, a * b, 0))`` over ``[nz, ny, nx]`` arrays in
    the kernel's order: one item a voxel, or, with ``has_coarse``, one item
    a 2x2x2 block whose 8 products (e = dz*4 + dy*2 + dx) add as the tree
    at strides 4, 2, 1."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    w = torch.where(dot_m != 0, a * b, zero)
    if has_coarse:
        nz, ny, nx = w.shape
        w = _tree(w.reshape(nz // 2, 2, ny // 2, 2, nx // 2, 2)
                  .permute(0, 2, 4, 1, 3, 5).reshape(-1, 8))
    return blocked_sum(w.reshape(-1))


# ------------------------------------------------------------ launch plan

#: voxels a thread of the box form holds in registers at most
#: (``kMaxVoxels`` in ``csrc/poisson.cu``)
BICG_MAX_VOXELS = 8
#: dot partial slots and second-level partials a dot (``kDots``,
#: ``kMaxLevel2``)
BICG_DOTS = 3
BICG_MAX_LEVEL2 = _MAX_TILES // TILE
#: a brick's extents at most, (z, y, x) voxels (``kMaxBrick``: a voxel's
#: local coordinates pack into 10 / 11 / 11 bits)
BICG_MAX_BRICK = (1024, 2048, 2048)


@dataclass(frozen=True)
class BicgPlan:
    """How :func:`bicg_solve`'s kernel holds a ``[nz, ny, nx]`` solve:
    ``ctas`` CTAs of ``threads`` (one item a thread a tile) over ``tiles``
    dot tiles.  Form ``"box"``: each CTA takes ``tiles_per_cta`` whole
    tiles forming the brick ``brick = (bz, by, bx)`` voxels, tiles of
    ``tile_shape = (planes, rows, width)`` items (``(0, 0, 0)``: one brick,
    the whole grid, of consecutive tiles); each thread holds
    ``voxels_per_thread`` voxels.  Form ``"l2"``: the tiles cut into ``ctas`` runs
    (``resident.part``), the state in global memory.  ``smem_bytes`` is
    the dynamic shared memory a CTA; ``shared``, ``registers`` and ``l2``
    name what each place holds."""

    form: str
    tiles: int
    tiles_per_cta: int
    ctas: int
    threads: int
    brick: tuple
    tile_shape: tuple
    voxels_per_thread: int
    smem_bytes: int
    shared: tuple
    registers: tuple
    l2: tuple


def tile_shape(shape):
    """``(planes, rows, width)`` of a dot tile in an item grid ``shape =
    (Z, Y, X)`` where every tile is a box: whole planes (X·Y divides 256),
    whole rows of one plane (X divides 256) or 256 items of one row (256
    divides X); None where tiles are only runs of consecutive items."""
    Z, Y, X = shape
    if TILE % (X * Y) == 0 and Z % (TILE // (X * Y)) == 0:
        return (TILE // (X * Y), Y, X)
    if TILE % X == 0 and Y % (TILE // X) == 0:
        return (1, TILE // X, X)
    if X % TILE == 0:
        return (1, 1, TILE)
    return None


def bricks(k: int, shape):
    """Every brick of ``k`` whole tiles of an item grid ``shape``, as
    ``((bz, by, bx) items, tile shape)``: boxes of whole tiles that cut the
    grid evenly (``box_ok`` in the source), or, where ``k`` tiles cover the
    grid, the whole grid as one brick of consecutive tiles (tile shape
    ``(0, 0, 0)``)."""
    Z, Y, X = shape
    n = Z * Y * X
    if (k - 1) * TILE < n <= k * TILE:
        yield (Z, Y, X), (0, 0, 0)
        return
    ts = tile_shape(shape)
    if ts is None or n % (k * TILE):
        return
    tp, tr, tw = ts
    for bz in range(tp, Z + 1, tp):
        if Z % bz:
            continue
        for by in range(tr, Y + 1, tr):
            if Y % by or (k * TILE) % (bz * by):
                continue
            bx = k * TILE // (bz * by)
            if bx % tw == 0 and X % bx == 0:
                yield (bz, by, bx), ts


def halo_cells(brick) -> int:
    """Face cells of a brick's one-voxel halo (no edges or corners)."""
    bz, by, bx = brick
    return 2 * (bz * by + bz * bx + by * bx)


def bicg_box_bytes(brick, k: int) -> int:
    """Shared memory of the box form: the p0 and p1 boxes with a one-voxel
    halo, the six weights (each axis's pair with one plane more), the halo
    table (two ints a face cell of the halo) and the reductions' scratch
    (``box_floats``)."""
    bz, by, bx = brick
    n = 2 * (bz + 2) * (by + 2) * (bx + 2)
    n += 2 * (bz * by * (bx + 1) + bz * (by + 1) * bx + (bz + 1) * by * bx)
    n += 2 * halo_cells(brick)
    return 4 * (n + 2 * k * TILE + BICG_DOTS * BICG_MAX_LEVEL2 + 4)


#: shared memory of the l2 form: the reductions' scratch
BICG_L2_BYTES = 4 * (2 * TILE + BICG_DOTS * BICG_MAX_LEVEL2 + 4)

_BOX_REGISTERS = ("x", "r0", "r1", "best x", "Ap0", "ATp1", "scaling",
                  "masks (bits)")
_WEIGHTS = ("wpx", "wnx", "wpy", "wny", "wpz", "wnz")


@functools.lru_cache(maxsize=256)
def bicg_solve_plan(nz: int, ny: int, nx: int, has_coarse: bool, sms: int,
                    smem_per_block: int) -> BicgPlan:
    """:func:`bicg_solve`'s launch plan on a card of ``sms`` SMs and
    ``smem_per_block`` bytes of opt-in shared memory a CTA: the box form
    with the fewest tiles a CTA whose bricks fit the SMs, their shared
    memory and at most ``BICG_MAX_VOXELS`` voxels a thread, then the fewest
    halo cells; else the l2 form on ``min(sms, tiles)`` CTAs.  Raises
    ``ValueError`` where not even the l2 form fits."""
    if min(nz, ny, nx) < 1 or (has_coarse and (nz | ny | nx) & 1):
        raise ValueError(f"bicg_solve_plan: bad shape {(nz, ny, nx)} "
                         f"(has_coarse {has_coarse})")
    E, sh = (8, 1) if has_coarse else (1, 0)
    shape = (nz >> sh, ny >> sh, nx >> sh)
    items = shape[0] * shape[1] * shape[2]
    tiles = -(-items // TILE)
    if tiles > _MAX_TILES:
        raise ValueError(f"bicg_solve_plan: {tiles} dot tiles exceed {_MAX_TILES}")
    best = None
    for k in range(1, min(BICG_MAX_VOXELS // E, tiles) + 1):
        ctas = -(-tiles // k)
        if ctas > sms:
            continue
        for box, ts in bricks(k, shape):
            brick = tuple(b << sh for b in box)
            if any(b > m for b, m in zip(brick, BICG_MAX_BRICK)):
                continue
            smem = bicg_box_bytes(brick, k)
            key = (k, halo_cells(brick))
            if smem <= smem_per_block and (best is None or key < best[0]):
                best = (key, k, ctas, brick, ts, smem)
    if best is not None:
        _, k, ctas, brick, ts, smem = best
        return BicgPlan(
            form="box", tiles=tiles, tiles_per_cta=k, ctas=ctas, threads=TILE,
            brick=brick, tile_shape=ts, voxels_per_thread=k * E, smem_bytes=smem,
            shared=("p0 box", "p1 box") + _WEIGHTS + ("halo table",),
            registers=_BOX_REGISTERS, l2=("r0, r1 brick faces",))
    if BICG_L2_BYTES > smem_per_block:
        raise ValueError(f"bicg_solve_plan: not even the l2 form's "
                         f"{BICG_L2_BYTES} bytes fit {smem_per_block}")
    ctas = min(sms, tiles)
    return BicgPlan(
        form="l2", tiles=tiles, tiles_per_cta=-(-tiles // ctas), ctas=ctas,
        threads=TILE, brick=(), tile_shape=(), voxels_per_thread=0,
        smem_bytes=BICG_L2_BYTES, shared=(), registers=(),
        l2=("x", "r0", "r1", "p0", "p1", "Ap0", "ATp1", "best x") + _WEIGHTS
        + ("scaling", "masks"))


# ------------------------------------------------------------- BiCG loop

def bicg_loop(apply_fwd, apply_rev, rhs, x, solve_mask, dot, max_iter,
              stop_res, stop_inc):
    """The masked BiCG iteration (Numerical Recipes 2.7.6 with A and Aᵀ
    applied matrix-free, ``poisson_solve.hpp:251-520``) from ``x``, with the
    reference's stopping rules: the residual target ``stop_res``, the
    ``dot_r`` breakdown, and the best-solution tracking that stops once the
    residual grows ``stop_inc`` times past its best (BiCG semi-converges on
    the non-normal AMR systems; ``poisson_solve.hpp:246-250, 655-683``).

    ``rhs`` is masked to the solve rows already; the operators are
    restricted to them here (boundary and skip rows would otherwise leak
    into r and p).  ``dot(a, b)`` is the masked dot of the caller's space;
    ``stop_res`` and ``stop_inc`` are 0-dim tensors whose dtype sets the
    stopping tests' precision.  The while-condition is checked on the host
    once an iteration.  Returns ``(best_x, best_res, iterations)``."""
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    r0 = torch.where(solve_mask, rhs - apply_fwd(x), zero)
    r1, p0, p1 = r0, r0, r0
    dot_r = dot(r0, r0)
    res = torch.sqrt(torch.abs(dot_r))
    best_res, best_x = res, x
    it = 0
    while it < max_iter and bool(
            (res > stop_res) & (dot_r != 0) & (res <= best_res * stop_inc)):
        Ap0 = torch.where(solve_mask, apply_fwd(p0), zero)
        ATp1 = torch.where(solve_mask, apply_rev(p1), zero)
        dot_p = dot(p1, Ap0)
        alpha = torch.where(dot_p != 0, dot_r / dot_p, zero)
        x = x + alpha * p0
        r0 = r0 - alpha * Ap0
        r1 = r1 - alpha * ATp1
        new_dot_r = dot(r0, r1)
        beta = torch.where(dot_r != 0, new_dot_r / dot_r, zero)
        p0 = r0 + beta * p0
        p1 = r1 + beta * p1
        res = torch.sqrt(torch.abs(dot(r0, r0)))
        better = res < best_res
        best_res = torch.where(better, res, best_res)
        best_x = torch.where(better, x, best_x)
        dot_r = new_dot_r
        it += 1
    return best_x, best_res, it


# ------------------------------------------------------------- plain twin

def bicg_solve_plain(rhs, x0, wpx, wnx, wpy, wny, wpz, wnz, scaling, fine,
                     coarse, orig, solve_m, dot_m, max_iter, stop_res,
                     stop_inc, *, has_coarse):
    """Twin of :func:`bicg_solve`: :func:`bicg_loop` on the two-level flat
    operator (``flat_poisson.roll_apply``) with :func:`blocked_dot` for its
    dots and float32 thresholds, stopping at the first iteration whose
    while-condition fails (the TPU kernel's later iterations are frozen and
    change nothing)."""
    PLAIN_CALLS["bicg_solve"] += 1
    dev = rhs.device
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)
    W = ((wpx, wnx), (wpy, wny), (wpz, wnz))

    def accumulate(C):
        return pool_two_level(C, coarse, orig, fine) if has_coarse else C

    best_x, best_res, it = bicg_loop(
        lambda v: roll_apply(v, W, scaling, accumulate, False),
        lambda v: roll_apply(v, W, scaling, accumulate, True),
        rhs, x0.clone(), solve_m != 0,
        lambda a, b: blocked_dot(a, b, dot_m, has_coarse),
        int(max_iter), f32(stop_res), f32(stop_inc),
    )
    return (best_x, best_res.reshape(1),
            torch.tensor([it], dtype=torch.int32, device=dev))


# ----------------------------------------------------------------- kernel

_NAMES = ("rhs", "x0", "wpx", "wnx", "wpy", "wny", "wpz", "wnz", "scaling",
          "fine", "coarse", "orig", "solve_m", "dot_m")
_lib = None


def _kernels():
    """The compiled ``csrc/poisson.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("poisson")
        lib.bicg_solve.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 10
                                   + [ctypes.c_void_p])
        lib.bicg_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


def _plan_args(plan: BicgPlan):
    """The launcher's plan arguments: form (1 box, 0 l2), tiles a CTA,
    CTAs, brick, tile shape, shared memory bytes."""
    return (int(plan.form == "box"), plan.tiles_per_cta, plan.ctas,
            *(plan.brick or (0, 0, 0)), *(plan.tile_shape or (0, 0, 0)),
            plan.smem_bytes)


def bicg_solve(rhs, x0, wpx, wnx, wpy, wny, wpz, wnz, scaling, fine, coarse,
               orig, solve_m, dot_m, max_iter, stop_res, stop_inc, *,
               has_coarse):
    """Solve the flat Poisson system from ``x0`` in one launch.

    All arrays are float32 ``[nz, ny, nx]`` voxel arrays of one device (the
    tables of ``ops/flat_poisson.py``): ``rhs`` and ``x0`` already lifted
    and masked as the model's solve does, the six face weights, the
    diagonal, and the 0/1 masks ``fine``, ``coarse`` (= 1 - fine),
    ``orig`` (even-parity block origins), ``solve_m`` and ``dot_m``.
    ``has_coarse`` (extents then even) turns on the coarse-row pooling.
    Returns ``(best_x, best_res [1] float32, iters [1] int32)``."""
    tensors = (rhs, x0, wpx, wnx, wpy, wny, wpz, wnz, scaling, fine, coarse,
               orig, solve_m, dot_m)
    if _on_cpu(*tensors):
        return bicg_solve_plain(*tensors, max_iter, stop_res, stop_inc,
                                has_coarse=has_coarse)
    dev = rhs.device
    shape = tuple(rhs.shape)
    if len(shape) != 3:
        raise ValueError(f"rhs must be [nz, ny, nx], got {shape}")
    if has_coarse and any(n % 2 for n in shape):
        raise ValueError(f"has_coarse needs even extents, got {shape}")
    for nm, t in zip(_NAMES, tensors):
        _check(nm, t, shape, dev)
    max_iter = int(max_iter)
    if not -2 ** 31 <= max_iter < 2 ** 31:
        raise ValueError("max_iter must fit in int32")
    plan = bicg_solve_plan(*shape, bool(has_coarse), *card_limits(dev.index))
    out = torch.empty_like(rhs)
    res = torch.empty(1, dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    # r0, r1 (the box form publishes its faces there); the l2 form's x, p0
    # and p1 parity pairs, Ap0 and ATp1
    scratch = torch.empty((2 if plan.form == "box" else 9,) + shape,
                          dtype=torch.float32, device=dev)
    part = torch.empty(3 * plan.tiles, dtype=torch.float32, device=dev)
    err = _kernels().bicg_solve(
        *(t.data_ptr() for t in tensors), out.data_ptr(), res.data_ptr(),
        iters.data_ptr(), scratch.data_ptr(), part.data_ptr(), *shape,
        int(bool(has_coarse)), max_iter, float(np.float32(stop_res)),
        float(np.float32(stop_inc)), *_plan_args(plan),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("bicg_solve", err)
    return out, res, iters
