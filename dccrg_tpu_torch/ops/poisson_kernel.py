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

On CPU tensors the wrapper computes with the twin; on CUDA tensors it
launches the kernel or raises.  Launches count in
``ops.LAUNCHES["bicg_solve"]``, twin calls in ``ops.PLAIN_CALLS``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu
from .flat_poisson import pool_two_level, roll_apply

__all__ = ["bicg_fits", "blocked_sum", "blocked_dot", "bicg_loop",
           "bicg_solve", "bicg_solve_plain"]

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
                                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.bicg_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    n = int(np.prod(shape))
    n_tiles = -(-(n // 8 if has_coarse else n) // TILE)
    if n_tiles > _MAX_TILES:
        raise ValueError(f"{n} voxels exceed the kernel's {_MAX_TILES} dot tiles")
    out = torch.empty_like(rhs)
    res = torch.empty(1, dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty((7,) + shape, dtype=torch.float32, device=dev)
    part = torch.empty(3 * n_tiles, dtype=torch.float32, device=dev)
    err = _kernels().bicg_solve(
        *(t.data_ptr() for t in tensors), out.data_ptr(), res.data_ptr(),
        iters.data_ptr(), scratch.data_ptr(), part.data_ptr(), *shape,
        int(bool(has_coarse)), max_iter, float(np.float32(stop_res)),
        float(np.float32(stop_inc)), torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("bicg_solve", err)
    return out, res, iters
