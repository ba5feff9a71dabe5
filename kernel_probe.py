#!/usr/bin/env python3
"""Chip-side probes of the Vlasov step kernel B7 and the BiCG whole-solve
kernel B8 that ``chip_smoke.py`` does not run.

Run from the repository root on a machine with a CUDA card (an H100):

    python3 kernel_probe.py vlasov-sweep    # B7 forms x plans, 32^3 x 512 bins
    python3 kernel_probe.py bicg-profile    # B8 cycles an iteration by phase

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
    sx, sy, sz = V.split_scales(dt, kw["inv_dx"], np.float32)
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
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        print(f"form kMaxRows {rows}, kStages {stages}, kMinCtas {ctas}: {'; '.join(regs)}",
              flush=True)
        for chunk, ty, threads, zp in itertools.product((32, 16, 8, 4), (4, 8, 16),
                                                        (256, 128), (1, 2, 4)):
            tx = threads // chunk
            smem = 4 * stages * (ty + 2) * (tx + 2) * chunk
            if ty > rows or tx > 32 or smem > 227 * 1024:
                continue

            def go():
                err = fn(*ptrs, D, nzl, ny, nx, nb, 1, 1, 1, 1, sx, sy, sz, ty, tx,
                         chunk, 4, zp, threads, smem, stream)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    if len(sys.argv) != 2 or sys.argv[1] not in ("vlasov-sweep", "bicg-profile"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)
    print(card, flush=True)
    return (vlasov_sweep if sys.argv[1] == "vlasov-sweep" else bicg_profile)(card)


if __name__ == "__main__":
    sys.exit(main())
