"""BRIEF-256 sampling pattern, generated deterministically.

The reference ships OpenCV's learned 256-pair pattern as a literal table
(jni/ORB_SLAM2/src/ORBextractor.cc:155-413, ``bit_pattern_31_``). We do NOT
copy that table; instead we generate our own pattern with the original BRIEF
recipe (Calonder et al.: sample point pairs from an isotropic Gaussian with
sigma = patch/5, clamped to the patch disc), from a fixed seed so descriptors
are reproducible across runs. Descriptors are therefore not bit-compatible
with OpenCV ORB — irrelevant here, because the vocabulary is also trained
in-framework (see bow/vocabulary.py) rather than loaded from ORBvoc.txt.
"""

from __future__ import annotations

import functools

import numpy as np

PATCH_SIZE = 31       # ORBextractor.cc:77
HALF_PATCH = 15       # ORBextractor.cc:78
EDGE_MARGIN = 19      # ORBextractor.cc:79 (EDGE_THRESHOLD)
N_PAIRS = 256
PATTERN_SEED = 20260817


@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32: for each pair, two (x, y) offsets within the patch.

    Points are i.i.d. N(0, (patch/5)^2) clamped to the radius-`HALF_PATCH`
    disc, so any rotation of the pattern stays inside a (2*HALF_PATCH+1)^2
    patch (rotations preserve the norm).
    """
    rng = np.random.default_rng(PATTERN_SEED)
    pts = rng.normal(scale=PATCH_SIZE / 5.0, size=(N_PAIRS * 2, 2))
    norm = np.linalg.norm(pts, axis=1, keepdims=True)
    scale = np.minimum(1.0, (HALF_PATCH - 1.0) / np.maximum(norm, 1e-9))
    pts = np.round(pts * scale).astype(np.int32)
    return pts.reshape(N_PAIRS, 2, 2)


@functools.lru_cache(maxsize=None)
def orientation_disc() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular-patch mask and coordinate grids for intensity-centroid
    orientation (IC_Angle, ORBextractor.cc:82-109).

    Returns (mask, xs, ys): each (31, 31) float32 with mask=1 inside the
    radius-15 disc.
    """
    r = HALF_PATCH
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    mask = (xs**2 + ys**2 <= r**2 + 1e-3).astype(np.float32)
    return mask, xs, ys
