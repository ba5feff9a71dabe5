"""Blocked Vlasov step kernel (CUDA) and its plain PyTorch twin.

:func:`vlasov_step` replaces the JAX package's ``ops/vlasov_kernel.py::
make_vlasov_step_blocked``: one dimension-split upwind step (x, then y,
then z) of the dense phase-space array ``f [D, nzl, ny, nx, B]`` (B = nv³
velocity bins, minor) in one pass, all D slab slots in one launch
(``csrc/vlasov.cu``).  The z split's neighbour values are the x-then-y
split of the neighbouring planes, recomputed; at a slab's ends they come
from the device-edge planes: by default the slab ring's (:func:`ring_edges`,
the neighbouring slabs' end planes, vacuum past an open z end), which the
kernel reads from ``f`` itself, or ``edge_lo`` / ``edge_hi`` ``[D, 1, ny,
nx, B]`` given by the caller.  Op order and scalar association are the XLA
body's (``models/vlasov.py``), so :func:`split_xy` / :func:`split_z` also serve
the model's plain step for float64.

The kernel runs under a pure-Python launch plan (:func:`vlasov_step_plan`):
a CTA owns a spatial tile of one chunk of bins over a run of z planes,
staging each plane's window in shared memory; the plan picks the tile, the
chunk, the z run and the shared memory, and the C launcher refuses a plan
that does not cover the shape it is given.  The z-block height ``block``
(the TPU kernel's tile, kept for dispatch parity with the JAX package)
changes neither the plan nor the values.

On CPU tensors the wrapper computes with :func:`vlasov_step_blocked_plain`;
on CUDA tensors it launches the kernel or raises.  Launches count in
``ops.LAUNCHES["vlasov_step"]``, twin calls in
``ops.PLAIN_CALLS["vlasov_step"]``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import numpy_dtype
from . import LAUNCHES, PLAIN_CALLS
from .dense_advection import _check, _launched, _on_cpu
from .resident import card_limits

__all__ = ["LAUNCHES", "PLAIN_CALLS", "VlasovPlan", "pick_vlasov_block",
           "ring_edges", "split_scales", "split_xy", "split_z", "vlasov_step",
           "vlasov_step_blocked_plain", "vlasov_step_plan"]

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


# ------------------------------------------------------------ launch plan

#: threads a CTA at most (``kThreads`` in ``csrc/vlasov.cu``): a thread a
#: (x, bin) column of the tile
VLASOV_THREADS = 256
#: tile rows at most (``kMaxRows``): a thread keeps two planes of xy-split
#: values for its cells in registers
VLASOV_MAX_ROWS = 16
#: window buffers in shared memory (``kStages``): the next planes are in
#: flight while this one computes
VLASOV_STAGES = 3
#: bins a chunk at most: 64 bytes a window position, a 16 x 16 tile of
#: 256 columns (the fastest of 32-, 16- and 8-bin chunks on the H100)
VLASOV_MAX_CHUNK = 16
#: CTAs an SM hold at once (``kMinCtas``, the launch bound's): the z runs
#: fill them in one wave and no more
VLASOV_CTAS_PER_SM = 2


@dataclass(frozen=True)
class VlasovPlan:
    """How :func:`vlasov_step`'s kernel cuts ``f [D, nzl, ny, nx, B]``: a
    CTA a ``tile = (ty, tx)`` cell tile (the largest of ``tiles = (n_ty,
    n_tx)``, cut as ``resident.part`` cuts) of ``chunk`` bins (``chunks`` of
    them, the last ragged) over a run of a slab's planes (``z_parts`` runs,
    cut the same way), ``threads = chunk * tx`` a CTA (a thread a column),
    ``vec`` floats a copy (4: 16 bytes), ``smem_bytes`` of dynamic shared
    memory.  ``shared``, ``registers`` and ``l2`` name what each place
    holds."""

    tile: tuple
    tiles: tuple
    chunk: int
    chunks: int
    vec: int
    z_parts: int
    threads: int
    ctas: int
    smem_bytes: int
    shared: tuple
    registers: tuple
    l2: tuple


def vlasov_smem_bytes(tile, chunk: int) -> int:
    """Shared memory of a tile: ``VLASOV_STAGES`` plane windows of
    ``(ty+2) x (tx+2) x chunk`` floats (``smem_floats`` in the source)."""
    ty, tx = tile
    return 4 * VLASOV_STAGES * (ty + 2) * (tx + 2) * chunk


@functools.lru_cache(maxsize=256)
def vlasov_step_plan(D: int, nzl: int, ny: int, nx: int, B: int, sms: int,
                     smem_per_block: int) -> VlasovPlan:
    """:func:`vlasov_step`'s launch plan on a card of ``sms`` SMs and
    ``smem_per_block`` bytes of opt-in shared memory a CTA: chunks of at
    most ``VLASOV_MAX_CHUNK`` bins; tiles of at most ``VLASOV_MAX_ROWS``
    rows and as many columns as ``VLASOV_THREADS`` threads hold, halved
    along the longer side until the windows fit; as many z runs as keep
    the CTAs within one wave of ``VLASOV_CTAS_PER_SM`` an SM.  Raises
    ``ValueError`` where no tile fits."""
    if min(D, nzl, ny, nx, B, sms) < 1:
        raise ValueError(f"vlasov_step_plan: bad shape {(D, nzl, ny, nx, B)}")
    chunk = min(B, VLASOV_MAX_CHUNK)
    vec = 4 if B % 4 == 0 and chunk % 4 == 0 else 1
    ty, tx = min(ny, VLASOV_MAX_ROWS), min(nx, VLASOV_THREADS // chunk)
    while True:
        tiles = (-(-ny // ty), -(-nx // tx))
        tile = (-(-ny // tiles[0]), -(-nx // tiles[1]))
        smem = vlasov_smem_bytes(tile, chunk)
        if smem <= smem_per_block:
            break
        if tile == (1, 1):
            raise ValueError(
                f"vlasov_step_plan: no tile of {chunk}-bin chunks fits "
                f"{smem_per_block} bytes of shared memory a CTA (a 1x1 tile "
                f"needs {smem})")
        if tile[0] >= tile[1]:
            ty = max(1, tile[0] // 2)
        else:
            tx = max(1, tile[1] // 2)
    chunks = -(-B // chunk)
    per_run = D * tiles[0] * tiles[1] * chunks
    z_parts = min(nzl, max(1, VLASOV_CTAS_PER_SM * sms // per_run))
    return VlasovPlan(
        tile=tile, tiles=tiles, chunk=chunk, chunks=chunks, vec=vec,
        z_parts=z_parts, threads=chunk * tile[1], ctas=per_run * z_parts,
        smem_bytes=smem, shared=("f plane windows",),
        registers=("x and y splits of a column", "xy split of planes z-1, z",
                   "vx, vy, vz"), l2=())


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


def ring_edges(f, periodic_z: bool):
    """The planes below and above each slab of ``f [D, nzl, ...]`` on the
    slab ring: the neighbouring slabs' end planes (``HaloExtend.planes``),
    vacuum (0) below the first slab and above the last on an open z axis."""
    lo, hi = torch.roll(f[:, -1:], 1, 0), torch.roll(f[:, :1], -1, 0)
    if not periodic_z:
        lo[0] = 0
        hi[-1] = 0
    return lo, hi


def vlasov_step_blocked_plain(f, edge_lo, edge_hi, vx, vy, vz, dt, *, block,
                              inv_dx, periodic):
    """Twin of :func:`vlasov_step` (``vlasov_kernel.py:71-107`` in torch).
    The z-block size ``block`` does not change the values; ``edge_lo`` /
    ``edge_hi`` None take the slab ring's planes (:func:`ring_edges`)."""
    PLAIN_CALLS["vlasov_step"] += 1
    if edge_lo is None and edge_hi is None:
        edge_lo, edge_hi = ring_edges(f, bool(periodic[2]))
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
        lib.vlasov_step.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                    + [ctypes.c_float] * 3 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
        lib.vlasov_step.restype = ctypes.c_int
        _lib = lib
    return _lib


def _plan_args(plan: VlasovPlan):
    """The launcher's plan arguments: tile, chunk, vec, z runs, threads,
    shared memory bytes."""
    return (*plan.tile, plan.chunk, plan.vec, plan.z_parts, plan.threads,
            plan.smem_bytes)


def vlasov_step(f, edge_lo, edge_hi, vx, vy, vz, dt, *, block, inv_dx,
                periodic):
    """One step of ``f [D, nzl, ny, nx, B]`` (float32) with per-bin
    velocities ``vx`` / ``vy`` / ``vz [B]``.  ``edge_lo`` / ``edge_hi`` are
    the device-edge planes ``[D, 1, ny, nx, B]``, or both None for the slab
    ring's (:func:`ring_edges`: on CUDA the kernel reads them from ``f``);
    ``block`` is the TPU kernel's z-tile height (a divisor of nzl; it does
    not change the values), ``inv_dx`` the inverse level-0 cell lengths and
    ``periodic`` the (x, y, z) periodicity.  Returns the new ``f``."""
    ring = edge_lo is None and edge_hi is None
    tensors = (f, vx, vy, vz) if ring else (f, edge_lo, edge_hi, vx, vy, vz)
    if _on_cpu(*tensors):
        return vlasov_step_blocked_plain(f, edge_lo, edge_hi, vx, vy, vz, dt,
                                         block=block, inv_dx=inv_dx,
                                         periodic=periodic)
    if f.dim() != 5:
        raise ValueError(f"f must be [D, nzl, ny, nx, B], got {tuple(f.shape)}")
    D, nzl, ny, nx, B = f.shape
    if block < 1 or nzl % block:
        raise ValueError(f"block {block} does not divide nzl {nzl}")
    dev = f.device
    _check("f", f, (D, nzl, ny, nx, B), dev)
    if not ring:
        _check("edge_lo", edge_lo, (D, 1, ny, nx, B), dev)
        _check("edge_hi", edge_hi, (D, 1, ny, nx, B), dev)
    for nm, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        _check(nm, t, (B,), dev)
    sx, sy, sz = split_scales(dt, inv_dx, np.float32)
    plan = vlasov_step_plan(D, nzl, ny, nx, B, *card_limits(dev.index))
    # 16-byte copies need 16-byte aligned arrays (a view may start anywhere)
    al = lambda t: None if t is None else t if t.data_ptr() % 16 == 0 else t.clone()
    f, edge_lo, edge_hi = al(f), al(edge_lo), al(edge_hi)
    ptr = lambda t: None if t is None else t.data_ptr()
    out = torch.empty_like(f)
    err = _kernels().vlasov_step(
        ptr(f), ptr(edge_lo), ptr(edge_hi), ptr(vx), ptr(vy), ptr(vz),
        out.data_ptr(), D, nzl, ny, nx, B, int(bool(periodic[0])),
        int(bool(periodic[1])), int(bool(periodic[2])), int(ring), sx, sy, sz,
        *_plan_args(plan), torch.cuda.current_stream(dev).cuda_stream,
    )
    _launched("vlasov_step", err)
    return out
