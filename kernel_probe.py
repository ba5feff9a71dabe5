#!/usr/bin/env python3
"""Chip-side probes of the Vlasov step kernel B7, the BiCG whole-solve
kernel B8, the halo gather B9, the flat-against-boxed dispatch edges, the
telemetry's host cost and the cohort kernels' member axis that
``chip_smoke.py`` does not run.

Run from the repository root on a machine with a CUDA card (an H100):

    python3 kernel_probe.py vlasov-sweep    # B7 forms x plans, 32^3 x 512 bins
    python3 kernel_probe.py bicg-profile    # B8 cycles an iteration by phase
    python3 kernel_probe.py ring-sweep [--baseline DIR]   # B9 forms
    python3 kernel_probe.py boxed-edge      # flat forms against boxed passes
    python3 kernel_probe.py telemetry-cost  # obs on / off on the refined run
    python3 kernel_probe.py cohort-launch   # member axis vs a launch a member
    python3 kernel_probe.py ipc-wait        # ipc: host against stream waits

``vlasov-sweep`` compiles copies of ``csrc/vlasov.cu`` with other tile rows
(``kMaxRows``), window stages (``kStages``) and CTAs an SM (``kMinCtas``),
launches each under plans of other chunks, tiles and z runs on one seeded
32^3 x 512 phase space (f and the output exceed the 50 MB L2), holds each
result bitwise against the twin and prints its mean device time over 30
launches (CUDA events), the shipped form and plan first.

``bicg-profile`` compiles a copy of ``csrc/poisson.cu`` with clock64 stamps
at the phase boundaries of the box form's iteration, taken by thread 0 of
CTA 0, runs 60 iterations on seeded operands of both 64^3 grids (with and
without coarse rows), holds the solution against the twin, and prints the
cycles an iteration each phase took.  The stamps themselves add time.

``ring-sweep`` compiles copies of ``csrc/halo_dma.cu`` that each change
one thing from the shipped form (``RING_FORMS``, all built at once): rows
a thread of one-word rows in payloads (``kRowsPayload``) and where the
field's own rows are read (``kRowsOwn``), the CTA cap (``kMaxCtas``; 0 is
one wave), words a lane (``kLaneWords``), bytes of one-word rows a thread
(``kRunBytes``), fields a launch (``kMaxFields``, the size of the
by-value parameter block) and how row words are read (``load_narrow`` for
one-word rows, ``load_wide`` for wider ones: the read-only path, plain or
streaming loads).  It launches each on the main path's shapes: the 8-slot
refined 48^3 grid's density payload (f32, 4 bytes a row), the three-field
blocking exchange and merge (f64, f32 (3,), uint32) of that grid, and the
8-slot refined 16^3 grid's Vlasov payload (512 f32, 2 KiB a row).  Each
result is held bitwise against the twin; each time is the mean device
time of 200 launches queued behind a device-side sleep (CUDA events),
taking turns over copies of the inputs that exceed the 50 MB L2, each
launch allocating its outputs as the main path does.  An empty kernel
(``chip_smoke.py``'s ``BARRIER_PROBE``) is timed in the same harness, the
launch floor.  With ``--baseline DIR`` it also builds ``DIR``'s
``csrc/halo_dma.cu`` (the one-field ``ring_copy`` interface of an earlier
checkout) and times it beside every form at the two payload shapes in
``chip_smoke.py``'s harness (the index warm, an output allocated a
launch), in turns (baseline, the forms, the forms reversed, baseline),
and the three-field blocking exchange on that checkout's protocol against
one launch.

``cohort-launch`` steps W members of a cohort two ways, at W = 1, 4, 16
and 64: one launch with the member axis (the shipped form) and W launches
of one member each (the alternative), and B7's member launch also under
a plan made for all W members' slots, for B2 at the headline member
(128x128x64 on one slot, z-blocks of 16: the blocked dense step with its
slab-ring planes) and B7 at the bench's Vlasov member (32^3 x 512 bins).
Each member's dt differs; the two forms are held bitwise against each
other.  It prints the mean device time a cohort step (CUDA events around
20 steps issued back to back, so the host's issue time between launches
shows) and the host's wall time a step (synchronised).

``boxed-edge`` runs the refined grids of ``chip_smoke.py`` (48^3 with one
ball refined, 96^3 voxels; 16^3 with two, 64^3 voxels) through the flat
form the dispatch picks (B5, B6, and in float64 the ``ml`` pyramid form)
and through the boxed per-level passes, and prints each one's voxel-updates
a second (wall clock, median of 3 runs) and their ratio: the edge
``models/advection.py`` prefers the boxed passes past
(``FLAT_BOXED_EDGE``, ``ML_BOXED_EDGE``).

``telemetry-cost`` runs the refined 48^3 grid's ``run(200)`` (B5) with the
metrics registry on and ``disable()``d in turns (off, on, on, off; three
rounds of 20 runs each), printing each batch's median wall time (host
clock around the run and a synchronise) and mean host enqueue time (50
runs queued, no synchronise between them), then the host time of one
``fused.*`` run record and of the schedule's ``bytes_moved`` it reads.

``ipc-wait`` runs ``chip_smoke.py`` phase 34's two launches of 2
controllers x 4 slots over the ``ipc`` transport (phase 32's run: the
density exchange, the dense cases, the models; phase 33's split cases and
cohorts) in turns (host, stream, stream, host), once as shipped, where a
controller waits for a peer's event on the host (``parallel/ipc.py::
_peer_wait``), and once with that wait queued on the controller's current
stream instead (``cudaStreamWaitEvent``).  It prints controller 0's wall ms
of every case (``chip_smoke._ipc_cases``) each turn and their sum.  The
results are not checked against the oracle here (phase 34 does that).

Copies build into ``dccrg_tpu_torch/_build/probe/``.  Without CUDA the
script exits 1 and prints nothing else.
"""
from __future__ import annotations

import ctypes
import itertools
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
#: (kMaxRows, kStages, kMinCtas) of the B7 forms the sweep builds, the
#: shipped one first
VLASOV_FORMS = [(16, 3, 2), (16, 3, 1), (8, 3, 2), (8, 2, 2), (8, 4, 2), (8, 3, 3),
                (8, 3, 4), (4, 4, 4)]
#: the B8 box iteration's phases, in the order of the stamps after them
BICG_PHASES = ["A compute", "A partials", "barrier 1", "totals A", "B compute",
               "B partials", "barrier 2", "totals B", "own fold", "halo fold",
               "end sync"]
#: (text in csrc/poisson.cu, the same with its stamps)
BICG_STAMPS = [
    ("    // A: Ap0, ATp1, partials of dot(p1, Ap0)\n    float AP[kMaxVoxels]",
     "    unsigned long long _pt = clock64();\n"
     "    // A: Ap0, ATp1, partials of dot(p1, Ap0)\n    float AP[kMaxVoxels]"),
    ("    tile_partials(a, red, 1, s0, TID, k);\n    grid.sync();",
     "    PROF(0) tile_partials(a, red, 1, s0, TID, k); PROF(1)\n    grid.sync(); PROF(2)"),
    ("    totals(a, red, 1, s0, tot);\n    const float dot_p = tot[0];\n"
     "    const float alpha = dot_p != 0.f ? div(dot_r, dot_p) : 0.f;\n#pragma unroll",
     "    totals(a, red, 1, s0, tot); PROF(3)\n    const float dot_p = tot[0];\n"
     "    const float alpha = dot_p != 0.f ? div(dot_r, dot_p) : 0.f;\n#pragma unroll"),
    ("    tile_partials(a, red, 2, s12, TID, k);\n    grid.sync();",
     "    PROF(4) tile_partials(a, red, 2, s12, TID, k); PROF(5)\n    grid.sync(); PROF(6)"),
    ("    totals(a, red, 2, s12, tot);\n    const float new_dot_r = tot[0];\n    const float beta",
     "    totals(a, red, 2, s12, tot); PROF(7)\n    const float new_dot_r = tot[0];\n"
     "    const float beta"),
    ("      if (better) BEST[v] = X[v];\n    }\n",
     "      if (better) BEST[v] = X[v];\n    }\n    PROF(8)\n"),
    ("    __syncthreads();\n    if (better) best_res = res_new;",
     "    PROF(9) __syncthreads(); PROF(10)\n    if (better) best_res = res_new;"),
]
#: the B9 forms the ring sweep builds: a label and the edits that make it
#: from the shipped source (a compile-time constant's value, or the load a
#: load function returns: an intrinsic's name or "*" for a plain load), the
#: shipped form first
RING_FORMS = [("shipped", {})] + [
    (f"{name} {v}", {name: v}) for name, values in (
        ("kRowsPayload", (1, 4, 8)), ("kRowsOwn", (1, 2, 4)), ("kMaxCtas", (264, 2112, 4224)),
        ("kLaneWords", (2,)), ("kRunBytes", (16,)), ("kMaxFields", (32,)))
    for v in values] + [
    (f"{fn} {load}", {fn: load}) for fn, loads in (("load_narrow", ("__ldcs", "*")),
                                                   ("load_wide", ("__ldg", "*")))
    for load in loads]
PROF_HEAD = """
__device__ unsigned long long g_prof[16];
#define PROF(k) if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  unsigned long long _n = clock64(); g_prof[k] += _n - _pt; _pt = _n; }
extern "C" int prof_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }
extern "C" int prof_reset() {
  unsigned long long z[16] = {0}; return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }
namespace {
"""


def build(name: str, src: str):
    """Compile ``src`` as ``lib<name>.so`` with the package's nvcc flags;
    returns the library and the ptxas lines of registers and spills."""
    from dccrg_tpu_torch import cuda_build

    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc exit {r.returncode}\n{log}")
    regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(out / f"lib{name}.so")), regs


def event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), the
    calls queued behind a device-side sleep as long as their host-side
    issue, so the host's launch overhead opens no gaps between them (the
    harness of ``chip_smoke.py``'s ``event_ms``)."""
    import time

    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    issue_s = min(1.5 * reps * (time.perf_counter() - t), 2.0)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(issue_s * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def vlasov_sweep(card: str) -> int:
    import numpy as np
    import torch

    from dccrg_tpu_torch.ops import vlasov_kernel as V

    dev = torch.device("cuda")
    D, nzl, ny, nx, nb = 1, 32, 32, 32, 512
    r = np.random.default_rng(3)
    f = torch.tensor(r.uniform(0, 1, (D, nzl, ny, nx, nb)).astype(np.float32), device=dev)
    v = torch.tensor(r.uniform(-1, 1, (3, nb)).astype(np.float32), device=dev)
    vx, vy, vz = (v[i].contiguous() for i in range(3))
    dt = float(np.float32(0.4 / 32))
    kw = dict(block=4, inv_dx=np.full(3, 32.0), periodic=(True, True, True))
    want = V.vlasov_step_blocked_plain(f, None, None, vx, vy, vz, dt, **kw)
    scales = torch.tensor([V.split_scales(dt, kw["inv_dx"], np.float32)],
                          dtype=torch.float32, device=dev)
    out = torch.empty_like(f)
    # the edge planes from the slab ring (the main path's form)
    ptrs = [f.data_ptr(), None, None] + [t.data_ptr() for t in (vx, vy, vz, out)]
    stream = torch.cuda.current_stream().cuda_stream
    print(f"torch copy_ of f (64 MiB read, 64 MiB written): "
          f"{event_ms(lambda: out.copy_(f), 30)!r} ms on {card}", flush=True)
    src = (ROOT / "dccrg_tpu_torch/csrc/vlasov.cu").read_text()
    ok = True
    for rows, stages, ctas in VLASOV_FORMS:
        s = src
        for name, value in (("kMaxRows", rows), ("kStages", stages), ("kMinCtas", ctas)):
            s, n = re.subn(rf"constexpr int {name} = \d+;",
                           f"constexpr int {name} = {value};", s)
            assert n == 1, name
        lib, regs = build(f"vlasov_r{rows}s{stages}m{ctas}", s)
        fn = lib.vlasov_step
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        print(f"form kMaxRows {rows}, kStages {stages}, kMinCtas {ctas}: {'; '.join(regs)}",
              flush=True)
        for chunk, ty, threads, zp in itertools.product((32, 16, 8, 4), (4, 8, 16),
                                                        (256, 128), (1, 2, 4)):
            tx = threads // chunk
            smem = 4 * stages * (ty + 2) * (tx + 2) * chunk
            if ty > rows or tx > 32 or smem > 227 * 1024:
                continue

            def go():
                err = fn(*ptrs, D, D, nzl, ny, nx, nb, 1, 1, 1, 1, scales.data_ptr(),
                         0.0, 0.0, 0.0, ty, tx, chunk, 4, zp, threads, smem, stream)
                assert err == 0, err
            out.zero_()
            go()
            torch.cuda.synchronize()
            equal = torch.equal(out, want)
            ok &= equal
            print(f"  rows {rows} stages {stages} ctas {ctas}: {chunk}-bin chunks, {ty}x{tx} "
                  f"tiles, {threads} threads, {zp} z runs, {smem} B: {event_ms(go, 30)!r} ms, "
                  f"bitwise {equal}", flush=True)
    print(f"plan {V.vlasov_step_plan(D, nzl, ny, nx, nb, 132, 227 * 1024)}; on {card}")
    return 0 if ok else 1


def bicg_synth(shape, hc, seed, dev):
    """Seeded operands: a perturbed Laplacian with random positive face
    weights, 90% solve rows, coarse rows as random 2x2x2 blocks."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)
    w = [r.uniform(0.5, 1.5, shape) for _ in range(6)]
    scaling = -sum(w) * r.uniform(1.0, 1.1, shape)
    if hc:
        blk = r.random(tuple(n // 2 for n in shape)) < 0.5
        fine = blk.repeat(2, 0).repeat(2, 1).repeat(2, 2)
        g = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij", sparse=True)
        orig = (g[0] % 2 == 0) & (g[1] % 2 == 0) & (g[2] % 2 == 0)
    else:
        fine, orig = np.ones(shape, bool), np.zeros(shape, bool)
    solve = r.random(shape) < 0.9
    rhs = np.where(solve, r.standard_normal(shape), 0.0)
    return [t(rhs), t(0.1 * r.standard_normal(shape))] + [t(a) for a in w] + [
        t(scaling), t(fine), t(~fine), t(orig), t(solve), t(solve)]


def bicg_profile(card: str) -> int:
    import numpy as np
    import torch

    from dccrg_tpu_torch.ops import poisson_kernel as B
    from dccrg_tpu_torch.ops import resident as R

    dev = torch.device("cuda")
    src = (ROOT / "dccrg_tpu_torch/csrc/poisson.cu").read_text()
    for text, stamped in BICG_STAMPS:
        assert src.count(text) == 1, f"stamp site not found once: {text!r}"
        src = src.replace(text, stamped)
    lib, regs = build("poisson_profile", src.replace("namespace {\n", PROF_HEAD, 1))
    print(f"instrumented build: {'; '.join(regs)}", flush=True)
    lib.bicg_solve.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                               + [ctypes.c_float] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    ok = True
    for hc in (True, False):
        shape = (64, 64, 64)
        arrays = bicg_synth(shape, hc, 7, dev)
        plan = B.bicg_solve_plan(*shape, hc, *R.card_limits(dev.index))
        out, res = torch.empty_like(arrays[0]), torch.empty(1, device=dev)
        its = torch.empty(1, dtype=torch.int32, device=dev)
        scratch = torch.empty((9,) + shape, device=dev)
        part = torch.empty(3 * plan.tiles, device=dev)

        def go():
            err = lib.bicg_solve(*(t.data_ptr() for t in arrays), out.data_ptr(),
                                 res.data_ptr(), its.data_ptr(), scratch.data_ptr(),
                                 part.data_ptr(), *shape, int(hc), 60, 0.0, float("inf"),
                                 *B._plan_args(plan), torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        go()
        torch.cuda.synchronize()
        want = B.bicg_solve_plain(*arrays, 60, 0.0, float("inf"), has_coarse=hc)
        equal = torch.equal(out, want[0]) and int(its[0]) == int(want[2][0]) == 60
        ok &= equal
        ms = event_ms(go, 5)
        lib.prof_reset()
        go()
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 16)()
        lib.prof_read(h)
        total = sum(h[:len(BICG_PHASES)])
        print(f"{'x'.join(map(str, shape))} {'coarse rows' if hc else 'uniform'}, plan "
              f"{plan.form} {plan.brick}: {ms!r} ms for 60 iterations (instrumented), "
              f"solution equal to the twin {equal}; cycles an iteration, CTA 0:", flush=True)
        for k, name in enumerate(BICG_PHASES):
            print(f"  {name:12s} {h[k] / 60:9.0f}  {100 * h[k] / total:5.1f}%")
        print(f"  total {total / 60:.0f} cycles an iteration on {card}", flush=True)
    return 0 if ok else 1


def ring_form(src: str, edits) -> str:
    """``src`` with a B9 form's edits made, each exactly once."""
    for name, value in edits.items():
        if name.startswith("load_"):
            load = "*p" if value == "*" else f"{value}(p)"
            src, n = re.subn(rf"(T {name}\(const T\* p\) \{{ return )[^;]*;",
                             rf"\g<1>{load};", src)
        else:
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
        assert n == 1, name
    return src


def refined_grid(n, radius, center, n_devices):
    """``n``^3 periodic grid, the ball of ``radius`` around ``center``
    refined once, on ``n_devices`` slots (``chip_smoke.py``'s split grids)."""
    import numpy as np

    from dccrg_tpu_torch import CartesianGeometry, Grid

    g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(n_devices=n_devices))
    ids = g.get_cells()
    r = np.linalg.norm(g.geometry.get_center(ids) - np.asarray(center), axis=1)
    g.refine_completely_many(ids[r < radius])
    g.stop_refining()
    return g


def boxed_edge(card: str) -> int:
    """The per-voxel rate of each flat form over the boxed passes' on the
    refined grids: the dispatch edge the card gives."""
    import statistics
    import time

    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, CartesianGeometry, Grid

    def grid(n, radii, max_ref):
        g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
             .set_periodic(True, True, True).set_maximum_refinement_level(max_ref)
             .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / n,) * 3)
             .initialize())
        center = (0.3, 0.5, 0.5) if max_ref == 1 else (0.5, 0.5, 0.5)
        for rad in radii:
            ids = g.get_cells()
            r = np.linalg.norm(g.geometry.get_center(ids) - np.asarray(center), axis=1)
            lv = g.mapping.get_refinement_level(ids)
            g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
            g.stop_refining()
        return g

    def wall(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times)

    for label, g in (("refined", grid(48, (0.3,), 1)),
                     ("refined3", grid(16, (0.6, 0.55), 2))):
        for dtype in (np.float32, np.float64):
            adv = Advection(g, dtype=dtype, allow_dense=False)
            if adv._flat_run is None or adv._boxed_run is None:
                print(f"{label} {np.dtype(dtype).name}: flat {adv._flat_kind}, "
                      f"boxed {adv._boxed_run is not None}: no pair", flush=True)
                continue
            s = adv.initialize_state()
            dt = 0.4 * adv.max_time_step(s)
            n_flat = adv._flat_n_vox
            n_box = sum(int(np.prod(b.shape)) for b in adv.boxed.boxes.values())
            fs, bs = (200, 20) if adv._flat_kind.endswith("pallas") else (20, 20)
            adv._flat_run.run(s, 2, dt)
            adv._boxed_run(s, 2, dt)
            tf = wall(lambda: adv._flat_run.run(s, fs, dt))
            tb = wall(lambda: adv._boxed_run(s, bs, dt))
            rf, rb = n_flat * fs / tf, n_box * bs / tb
            print(f"{label} {np.dtype(dtype).name} {len(g.get_cells())} leaves: "
                  f"{adv._flat_kind} {n_flat} voxels {rf!r} voxel-updates/s "
                  f"({fs} steps in {tf!r} s); boxed {n_box} voxels {rb!r} "
                  f"voxel-updates/s ({bs} steps in {tb!r} s); edge {rf / rb!r}; "
                  f"the dispatch takes {'boxed' if adv._prefer_boxed else adv._flat_kind}"
                  f" on {card}", flush=True)
    return 0


def ring_sweep(card: str, baseline) -> int:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from chip_smoke import BARRIER_PROBE
    from dccrg_tpu_torch.parallel import halo_dma as H

    dev = torch.device("cuda")
    r = np.random.default_rng(9)
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    ex = refined_grid(48, 0.3, (0.3, 0.5, 0.5), 8).halo()
    exv = refined_grid(16, 0.3, (0.5, 0.5, 0.5), 8).halo()
    D, R, Rv = ex.D, ex.R, exv.R
    rings, rv = ex._rings, exv._rings
    three = [t(r.standard_normal((D, R)), torch.float64),
             t(r.standard_normal((D, R, 3)), torch.float32),
             t(r.integers(-2**31, 2**31, (D, R)), torch.int32)]
    pay3 = H.ring_gather_plain([(x, rings.send) for x in three])
    shapes = {
        "density payload": [(t(r.standard_normal((D, R)), torch.float32), rings.send)],
        "three-field blocking": [(x, rings.full) for x in three],
        "three-field merge": [(x, rings.merge, p) for x, p in zip(three, pay3)],
        "vlasov payload": [(t(r.standard_normal((8, Rv, 512)), torch.float32), rv.send)],
    }
    print(f"density payload {rings.send.numel()} rows of 4 B; three fields {D * R} rows of "
          f"8, 12 and 4 B; vlasov payload {rv.send.numel()} rows of 2048 B", flush=True)

    def cold(jobs):
        """Copies of the jobs' inputs that together exceed 128 MiB."""
        size = sum(x.numel() * x.element_size() for job in jobs for x in job)
        n = -(-(128 << 20) // size)
        return [[tuple(x.clone() for x in job) for job in jobs] for _ in range(n)]

    stream = torch.cuda.current_stream().cuda_stream
    src = (ROOT / "dccrg_tpu_torch/csrc/halo_dma.cu").read_text()
    sources = [(f"halo_dma_{i}", ring_form(src, edits)) for i, (_, edits) in
               enumerate(RING_FORMS)] + [("barrier_probe", BARRIER_PROBE)]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda a: build(*a), sources))
    libs = {}
    for (label, _), (lib, regs) in zip(RING_FORMS, built):
        lib.ring_gather.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        libs[label] = lib
        print(f"form {label}: " + "; ".join(regs), flush=True)
    empty = built[-1][0]
    empty.empty_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def go_empty(ctas, threads):
        assert empty.empty_launch(ctas, threads, stream) == 0
    for ctas, threads in ((1, 32), (77, 256), (264, 256)):
        print(f"empty kernel, {ctas} CTAs of {threads} threads: "
              f"{queued_ms(lambda: go_empty(ctas, threads), 200)!r} ms on {card}", flush=True)

    ok = True
    best = {}
    for label, jobs in shapes.items():
        want = H.ring_gather_plain(jobs)
        copies = cold(jobs)
        staged, desc0 = H._descriptors(copies[0])
        desc0 = np.array(desc0, dtype=np.int64)
        turn = iter(range(1 << 30))
        for form, lib in libs.items():
            def go():
                # outputs allocated a launch, as on the main path
                _, d = H._descriptors(copies[next(turn) % len(copies)])
                d = np.array(d, dtype=np.int64)
                assert lib.ring_gather(d.ctypes.data, len(d), stream) == 0
            for x in staged:
                x.zero_()
            assert lib.ring_gather(desc0.ctypes.data, len(desc0), stream) == 0
            torch.cuda.synchronize()
            equal = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                        for a, b in zip(staged, want))
            ok &= equal
            ms = queued_ms(go, 200)
            print(f"  {label}: {form}: {ms!r} ms, bitwise {equal}", flush=True)
            if label not in best or ms < best[label][0]:
                best[label] = (ms, form)
        del copies, staged
    for label, (ms, form) in best.items():
        print(f"best {label}: {ms!r} ms ({form}) on {card}")
    if baseline is not None:
        old, regs = build("halo_dma_baseline",
                          (pathlib.Path(baseline) / "dccrg_tpu_torch/csrc/halo_dma.cu").read_text())
        old.ring_copy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        print(f"baseline {baseline}: {'; '.join(regs)}", flush=True)
        # each launch allocates its output, as the main path does (the
        # caching allocator hands the same block back), over copies of the
        # field that exceed the L2; the index table stays warm: the baseline
        # and every form in turns (baseline, forms, forms reversed, baseline)
        for label in ("density payload", "vlasov payload"):
            (x, idx), = shapes[label]
            copies = [c[0][0] for c in cold(shapes[label])]
            rb = x[0, 0].numel() * x.element_size()
            turn = iter(range(1 << 30))

            def go_old():
                c = copies[next(turn) % len(copies)]
                out = torch.empty((idx.numel(),) + tuple(x.shape[2:]), dtype=x.dtype,
                                  device=dev)
                assert old.ring_copy(c.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                     idx.numel(), rb, stream) == 0

            def go_form(lib):
                def go():
                    _, d = H._descriptors([(copies[next(turn) % len(copies)], idx)])
                    d = np.array(d, dtype=np.int64)
                    assert lib.ring_gather(d.ctypes.data, 1, stream) == 0
                return go
            order = [None] + list(libs) + list(libs)[::-1] + [None]
            times = {}
            for form in order:
                ms = queued_ms(go_old if form is None else go_form(libs[form]), 200)
                times.setdefault(form, []).append(ms)
            print(f"A/B {label}: baseline {times[None]!r} ms on {card}", flush=True)
            for form in libs:
                print(f"A/B {label}: {form}: {times[form]!r} ms", flush=True)
            del copies
        # the three-field blocking exchange: the baseline's protocol (a ring
        # copy, a clone and an index_put_ a field) against one grouped launch
        recv = rings.recv.to(dev)
        send_ptr, n_send = rings.send.data_ptr(), rings.send.numel()

        def old_exchange():
            for x in three:
                row = x[0, 0].numel() * x.element_size()
                p = torch.empty((n_send,) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
                assert old.ring_copy(x.data_ptr(), p.data_ptr(), send_ptr, n_send, row,
                                     stream) == 0
                out = x.clone()
                out.view((-1,) + tuple(x.shape[2:]))[recv] = p

        blocking = shapes["three-field blocking"]
        times = [queued_ms(fn, 200) for fn in
                 (old_exchange, lambda: H.ring_gather(blocking),
                  lambda: H.ring_gather(blocking), old_exchange)]
        print(f"A/B three-field blocking exchange: baseline protocol (9 launches) "
              f"{times[0]!r}, shipped (1 launch) {times[1]!r}, shipped {times[2]!r}, "
              f"baseline protocol {times[3]!r} ms on {card}", flush=True)
    return 0 if ok else 1


def telemetry_cost(card: str) -> int:
    """The refined run's wall and host enqueue time with the registry on
    and off, and the host cost of its one record."""
    import statistics
    import time

    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, obs

    g = refined_grid(48, 0.3, (0.3, 0.5, 0.5), 1)
    adv = Advection(g, dtype=np.float32)
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)
    run = lambda: adv.run(state, 200, dt)

    def wall(reps=20):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return statistics.median(out)

    def host(fn, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        secs = (time.perf_counter() - t) / reps
        torch.cuda.synchronize()
        return secs

    print(f"refined run(200): {len(g.get_cells())} leaves, flat form "
          f"{adv._flat_kind}", flush=True)
    for _ in range(5):
        run()
    for rnd in range(3):
        for on in (False, True, True, False):
            (obs.enable if on else obs.disable)()
            print(f"round {rnd} telemetry {'on ' if on else 'off'}: wall "
                  f"{wall() * 1e3!r} ms (median of 20), host enqueue "
                  f"{host(run, 50) * 1e6!r} us (mean of 50) on {card}", flush=True)
    obs.enable()
    rec = host(lambda: adv._record_run("flat", 200, state), 2000)
    moved = host(lambda: g.halo(None).bytes_moved({"density": state["density"]}), 2000)
    print(f"one run record {rec * 1e6!r} us of host, its bytes_moved {moved * 1e6!r} us "
          f"(mean of 2000) on {card}", flush=True)
    return 0


def cohort_launch(card: str) -> int:
    import time

    import numpy as np
    import torch

    from dccrg_tpu_torch import Advection, CartesianGeometry, Grid, Vlasov
    from dccrg_tpu_torch.ops import resident as R
    from dccrg_tpu_torch.ops import vlasov_kernel as V

    dev = torch.device("cuda")

    def grid(n, nz):
        return (Grid().set_initial_length((n, n, nz)).set_neighborhood_length(0)
                .set_periodic(True, True, True)
                .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                              level_0_cell_length=(1 / n, 1 / n, 1 / nz))
                .initialize(n_devices=1, device=dev))

    def wall_ms(fn, reps=10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    ok = True
    adv = Advection(grid(128, 64), dtype=np.float32)
    s = adv.initialize_state()
    dt0 = 0.4 * adv.max_time_step(s)
    vl = Vlasov(grid(32, 32), nv=8, dtype=np.float32)
    f = vl.initialize_state()["f"]
    dtv = 0.4 * vl.max_time_step()
    print(f"B2 member: 128x128x64, {adv.dense_kind}; B7 member: 32^3 x 512, block "
          f"{vl._fused_block}", flush=True)
    for W in (1, 4, 16, 64):
        dts = [dt0 * (0.3 + 0.02 * w) for w in range(W)]
        dt_t = torch.tensor(dts, dtype=torch.float32, device=dev)
        x = {k: torch.stack([v] * W).contiguous() for k, v in s.items()}
        one = lambda: adv._step_density(x["density"], x["vx"], x["vy"], x["vz"], dt_t,
                                        members=True)
        each = lambda: [adv._step_density(x["density"][w], x["vx"][w], x["vy"][w],
                                          x["vz"][w], dts[w]) for w in range(W)]
        same = torch.equal(one(), torch.stack(each()))
        ok &= same
        print(f"B2 W={W}: member axis {event_ms(one, 20)!r} ms device, {wall_ms(one)!r} ms "
              f"wall; a launch a member {event_ms(each, 20)!r} ms device, "
              f"{wall_ms(each)!r} ms wall; bitwise {same} on {card}", flush=True)
        del x
        dts = [dtv * (0.3 + 0.02 * w) for w in range(W)]
        dt_t = torch.tensor(dts, dtype=torch.float32, device=dev)
        fw = torch.stack([f] * W).contiguous()
        one = lambda: vl._dense_step(fw, dt_t, members=True)
        each = lambda: [vl._dense_step(fw[w], dts[w]) for w in range(W)]
        same = torch.equal(one(), torch.stack(each()))
        ok &= same
        # the member launch under the plan made for all W x D slots (fewer,
        # longer z runs: the plan's only W-dependent choice) against the
        # shipped one-member plan
        p1 = V.vlasov_step_plan(1, 32, 32, 32, 512, *R.card_limits(0))
        pz = V.vlasov_step_plan(W, 32, 32, 32, 512, *R.card_limits(0))
        out = torch.empty_like(fw)
        scales = V.member_scales(dt_t, vl._inv_dx, torch.float32)

        def zrun():
            err = V._kernels().vlasov_step(
                fw.data_ptr(), None, None, vl._vx.data_ptr(), vl._vy.data_ptr(),
                vl._vz.data_ptr(), out.data_ptr(), W, 1, 32, 32, 32, 512, 1, 1, 1, 1,
                scales.data_ptr(), 0.0, 0.0, 0.0, *V._plan_args(pz),
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        zrun()
        same_z = torch.equal(out, one())
        ok &= same_z
        print(f"B7 W={W}: member axis {event_ms(one, 20)!r} ms device, {wall_ms(one)!r} ms "
              f"wall (the one-member plan: {p1.z_parts} z runs, {W * p1.ctas} CTAs); "
              f"under the {W}-member plan's {pz.z_parts} z runs ({pz.ctas} CTAs, the "
              f"launch alone) {event_ms(zrun, 20)!r} ms device, bitwise {same_z}; a launch a member "
              f"{event_ms(each, 20)!r} ms device, {wall_ms(each)!r} ms wall; bitwise {same} "
              f"on {card}", flush=True)
        del fw
        torch.cuda.empty_cache()
    return 0 if ok else 1


def ipc_wait(card: str) -> int:
    import tempfile

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dccrg_tpu_torch import cuda_build
    from dccrg_tpu_torch.parallel import mesh

    cuda_build.build(["ipc", "halo_dma", "dense_advection", "vlasov"])
    wd = tempfile.mkdtemp(prefix="ipc_wait_")
    env = {"DCCRG_HALO_BACKEND": "auto", "DCCRG_HALO_VERIFY": "0", "DCCRG_FAULT": "",
           "DCCRG_ENSEMBLE_VERIFY": "0"}
    for mode in ("host", "stream", "stream", "host"):
        me = [sys.executable, str(ROOT / "kernel_probe.py"), "ipc-wait-child", mode]
        r34 = mesh.launch(me + ["spmd33", wd, "ipc", "full", "cuda", "ipc"], 2,
                          timeout_s=300, env=env, cwd=str(ROOT))
        r32 = mesh.launch(me + ["spmd", wd, "8", "ipc", "full", "cuda", "full"], 2,
                          timeout_s=300, env=env, cwd=str(ROOT))
        ms = {k: v[0] for k, v in cs._ipc_cases(r32, r34).items()}
        print(f"ipc-wait {mode}: controller 0's wall ms {ms!r}; sum {sum(ms.values())!r} "
              f"on {card}", flush=True)
    return 0


def ipc_wait_child(mode: str, argv) -> int:
    """One controller of ``ipc-wait``: ``chip_smoke.py --child argv`` with the
    peer waits on the host (``host``, as shipped) or queued on the current
    stream (``stream``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dccrg_tpu_torch.parallel import ipc

    if mode == "stream":
        ipc._peer_wait = lambda ev: ipc._ok("stream wait", ipc._cuda().ipc_wait(
            ev, torch.cuda.current_stream().cuda_stream))
    return cs.child_main(argv)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["ipc-wait-child"]:
        return ipc_wait_child(args[1], args[2:])
    baseline = None
    if args[1:2] == ["--baseline"] and len(args) == 3:
        baseline = args.pop()
        args.pop()
    modes = ("vlasov-sweep", "bicg-profile", "ring-sweep", "boxed-edge", "telemetry-cost",
             "cohort-launch", "ipc-wait")
    if len(args) != 1 or args[0] not in modes \
            or (baseline is not None and args[0] != "ring-sweep"):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)
    print(card, flush=True)
    if args[0] == "ring-sweep":
        return ring_sweep(card, baseline)
    if args[0] == "boxed-edge":
        return boxed_edge(card)
    if args[0] == "telemetry-cost":
        return telemetry_cost(card)
    if args[0] == "cohort-launch":
        return cohort_launch(card)
    if args[0] == "ipc-wait":
        return ipc_wait(card)
    return (vlasov_sweep if args[0] == "vlasov-sweep" else bicg_profile)(card)


if __name__ == "__main__":
    sys.exit(main())
