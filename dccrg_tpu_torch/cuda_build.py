"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use (or all at once, in parallel, through :func:`build`)
into ``dccrg_tpu_torch/_build/``; the library's file name carries a hash of
its source and flags, so a stale build is never loaded.  Nothing here runs
when the package is imported.

Each library compiled counts one ``epoch.recompiles{kernel=<source stem>}``
in the metrics registry, and its ``nvcc`` seconds go into the ``compile``
phase (``parallel/exec_cache.py``); a library already on disk counts
nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

from .obs.registry import metrics
from .parallel.exec_cache import note_trace

__all__ = ["NVCC_FLAGS", "BUILD_LOG", "sources", "build", "load"]

_PKG = pathlib.Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: -fmad=false: no multiply-add contraction, so each kernel rounds every
#: operation exactly as its plain PyTorch twin does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

#: name -> {"cmd", "seconds", "ptxas"} for each library built by this process
BUILD_LOG: dict = {}

_libs: dict = {}


def sources() -> list:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> pathlib.Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + repr(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that have no current
    library, one ``nvcc`` process each, all started together.  Raises with
    the compiler's output if any build fails.  Returns ``BUILD_LOG``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        # compile beside the target and rename into place, so a concurrent
        # user never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        metrics.phase_add("compile", secs)
        metrics.inc("epoch.recompiles", kernel=name)
        note_trace(name)
        BUILD_LOG[name] = {
            "cmd": " ".join(cmd[:-3] + ["-o", str(out), cmd[-1]]),
            "seconds": secs,
            "ptxas": log,
        }
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
