"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

``nvcc`` compiles every source under ``csrc/`` into one shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), written to
``_build/`` beside this package (git-ignored) and loaded with ``ctypes``.
Nothing is built at import time: the CPU tests import every module on
machines without ``nvcc``. A later call reuses the library while it is newer
than every source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libslam_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_seconds: float | None = None
build_log: str = ""


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date."""
    global build_seconds, build_log
    srcs = _sources()
    if (
        os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in srcs)
    ):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.fast_score_nms_launch.argtypes = [P, P, I, I, P]
        L.windowed_best2_launch.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P, F, P, P, P, I, I, I, P,
        ]
        L.fast_score_nms_launch.restype = I
        L.windowed_best2_launch.restype = I
        _lib = L
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
