"""Native (C++) host-side I/O, loaded with ctypes (port of
weiner_slamit_v2_tpu/native/, with its own copies of the two sources:
importing the JAX package's ``native`` runs that package's ``__init__``,
which imports jax).

``voc_loader.cpp`` parses DBoW2 text vocabularies (the ~1M-line
ORBvoc.txt); ``image_io.cpp`` decodes grayscale PNG/PGM dataset frames. Both
are host I/O off the device path. The library is built with ``g++`` at first
use into ``weiner_slamit_v2_torch/_build/`` (never beside the sources); when
it cannot be built or loaded, every function returns None and the callers
use the Python paths (PIL for images, ``bow.vocabulary.load_dbow2_text`` for
vocabularies).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libwsnative.so")
SOURCES = [os.path.join(_DIR, "voc_loader.cpp"), os.path.join(_DIR, "image_io.cpp")]
_lock = threading.Lock()
_lib = None
_build_failed = False


class _VocData(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("L", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
        ("parents", ctypes.POINTER(ctypes.c_int64)),
        ("is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("descs", ctypes.POINTER(ctypes.c_uint8)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
    ]


def _stale() -> bool:
    return not os.path.exists(LIB_PATH) or any(
        os.path.getmtime(s) > os.path.getmtime(LIB_PATH) for s in SOURCES)


def _build() -> bool:
    """g++ into a temporary file, renamed into place (processes that build
    at once never load a half-written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, *SOURCES, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, LIB_PATH)
    return True


def get_lib():
    """The loaded library, built on first use; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if _stale() and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.voc_load_text.restype = ctypes.POINTER(_VocData)
        lib.voc_load_text.argtypes = [ctypes.c_char_p]
        lib.voc_free.argtypes = [ctypes.POINTER(_VocData)]
        lib.voc_free.restype = None
        lib.image_load_gray.restype = ctypes.c_int
        lib.image_load_gray.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.image_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.image_free.restype = None
        _lib = lib
        return _lib


def load_dbow2_text_native(path: str):
    """Parse a DBoW2 text vocabulary with the C++ parser: (k, L,
    dict(parent, is_leaf, desc, weight)), or None without the library (then
    ``bow.vocabulary.load_dbow2_text``)."""
    lib = get_lib()
    if lib is None:
        return None
    vp = lib.voc_load_text(os.fsencode(path))
    if not vp:
        return None
    v = vp.contents
    n = v.n_nodes
    out = (int(v.k), int(v.L), {
        "parent": np.ctypeslib.as_array(v.parents, (n,)).copy(),
        "is_leaf": np.ctypeslib.as_array(v.is_leaf, (n,)).copy().astype(bool),
        "desc": np.ctypeslib.as_array(v.descs, (n, 32)).copy(),
        "weight": np.ctypeslib.as_array(v.weights, (n,)).copy(),
    })
    lib.voc_free(vp)
    return out


def load_image_gray_native(path: str) -> np.ndarray | None:
    """Decode a grayscale PNG/PGM with the C++ decoder: (H, W) float32, or
    None (no library, a missing file or another format)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_float)()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.image_load_gray(os.fsencode(path), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    img = np.ctypeslib.as_array(buf, (h.value, w.value)).copy()
    lib.image_free(buf)
    return img
