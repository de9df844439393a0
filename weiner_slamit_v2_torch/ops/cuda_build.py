"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

``nvcc`` compiles each source in ``csrc/`` into its own shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``). All ``nvcc``
processes start together, so the build takes as long as the slowest source.
The libraries go to ``_build/`` beside this package (git-ignored) and are
loaded with ``ctypes``. Nothing is built at import time: the CPU tests import
every module on machines without ``nvcc``. A later call reuses a library
while it is newer than its source.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point, in the order of its C signature
SIGNATURES = {
    # (n_levels, imgs[], outs[], heights[], widths[], stream); the arrays live on the host
    "fast_score_nms_levels_launch": [_I, _P, _P, _P, _P, _P],
    # (d1, v1, pxy, win, lo, hi, d2, v2, xy2, oct2, w2, th, chi2_on,
    #  best_idx, best_dist, second_dist, B, N1, N2, stream)
    "windowed_best2_launch": [_P] * 11 + [_F, _I] + [_P] * 3 + [_I] * 3 + [_P],
}

_lib = None
build_seconds: float | None = None
build_log: str = ""


def sources(subdir: str = "") -> list[str]:
    """The .cu files directly in csrc/ (or in csrc/<subdir>/)."""
    return sorted(glob.glob(os.path.join(CSRC, subdir, "*.cu")))


def _lib_path(src: str) -> str:
    rel = os.path.relpath(src, CSRC)
    return os.path.join(BUILD_DIR, "lib" + rel.replace(os.sep, "_")[:-3] + ".so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def build(srcs: list[str]) -> list[str]:
    """Compile every stale source of ``srcs``, one nvcc process each, all at
    once; returns the libraries' paths."""
    global build_seconds, build_log
    stale = [s for s in srcs if not (os.path.exists(_lib_path(s))
                                     and os.path.getmtime(_lib_path(s)) >= os.path.getmtime(s))]
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for s in stale:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, s], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((s, tmp, proc))
        logs, failed = [], []
        for s, tmp, proc in jobs:
            out = proc.communicate()[0]
            logs.append(f"== {os.path.relpath(s, CSRC)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{os.path.relpath(s, CSRC)} ({proc.returncode})")
                os.unlink(tmp)
            else:
                os.replace(tmp, _lib_path(s))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    return [_lib_path(s) for s in srcs]


def load(srcs: list[str], signatures: dict) -> types.SimpleNamespace:
    """Build ``srcs`` and return their C entry points named in ``signatures``
    (name -> argtypes) as ctypes functions."""
    fns = {}
    for path in build(srcs):
        cdll = ctypes.CDLL(path)
        for name, argtypes in signatures.items():
            if hasattr(cdll, name):
                fn = getattr(cdll, name)
                fn.argtypes, fn.restype = argtypes, _I
                fns[name] = fn
    missing = set(signatures) - set(fns)
    if missing:
        raise RuntimeError(f"CUDA entry points missing from the build: {sorted(missing)}")
    return types.SimpleNamespace(**fns)


def lib() -> types.SimpleNamespace:
    """Every C entry point of csrc/*.cu, as ctypes functions (built on first
    call)."""
    global _lib
    if _lib is None:
        _lib = load(sources(), SIGNATURES)
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
