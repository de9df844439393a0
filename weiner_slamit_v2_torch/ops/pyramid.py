"""Image pyramid + Gaussian blur (port of weiner_slamit_v2_tpu/ops/pyramid.py;
ORBextractor::ComputePyramid, src/ORBextractor.cc:1138-1168, and the 7x7
sigma=2 blur of src/ORBextractor.cc:1117).

FAST compares exact pixel differences, so one ulp in a pyramid level moves
keypoints. Both operations therefore reproduce the reference's float32
arithmetic operation for operation instead of calling ``F.interpolate`` or a
convolution (which would also run through cuDNN/TF32 on the card):

* resize: ``jax.image.resize(linear, antialias=False)`` is two contractions
  with half-pixel triangle weights (rows first, then columns). Each output
  sample has two taps. The row pass evaluates ``fma(w1, x1, w0 * x0)``, the
  column pass ``w0 * x0 + w1 * x1`` with three roundings; the sample
  coordinate is ``fma(i + 0.5, in/out, -0.5)``. These are the forms
  XLA:CPU's dot takes for the first resize; for some deeper level shapes it
  sums otherwise and the levels differ by a few ulps
  (tests/test_torch_frontend.py::test_pyramid_levels).
* blur: separable, reflect-101 border, ordered shifted multiply-adds:
  ``fma(k0, x0, k1 * x1)``, then ``acc = fma(k[i], x[i], acc)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..util import device_const, fma


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Static (H, W) per level (ORBextractor.cc:1147: cvRound(w/scale))."""
    return [
        (int(round(h / scale_factor**lvl)), int(round(w / scale_factor**lvl)))
        for lvl in range(n_levels)
    ]


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level coords * scale -> level-0 coords)."""
    return np.asarray([scale_factor**l for l in range(n_levels)], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _taps(m: int, n: int):
    """Two-tap linear resize weights for one axis, size m -> n, computed as
    jax.image.resize computes its weight matrix (float32 throughout)."""
    inv = np.float32(1.0 / (n / m))
    base = np.arange(n, dtype=np.float32) + np.float32(0.5)
    sf = (base.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    x = np.abs(sf[None, :] - np.arange(m, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x).astype(np.float32)
    tot = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(
        np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
        w / np.where(tot != 0, tot, np.float32(1.0)), np.float32(0.0),
    ).astype(np.float32)
    w = np.where(((sf >= -0.5) & (sf <= m - 0.5))[None, :], w, np.float32(0.0))
    i0 = np.zeros(n, np.int64)
    i1 = np.zeros(n, np.int64)
    w0 = np.zeros(n, np.float32)
    w1 = np.zeros(n, np.float32)
    for j in range(n):
        nz = np.flatnonzero(w[:, j])
        assert 1 <= len(nz) <= 2, (m, n, j, nz)
        i0[j], w0[j] = nz[0], w[nz[0], j]
        i1[j], w1[j] = (nz[1], w[nz[1], j]) if len(nz) == 2 else (nz[0], 0.0)
    return i0, i1, w0, w1


def resize_linear(image: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 -> shape, bit-compatible with the reference's resize."""
    h, w = image.shape
    dev = image.device
    def taps(m, n):
        return device_const(("resize_taps", m, n), dev,
                            lambda d: tuple(torch.from_numpy(a).to(d) for a in _taps(m, n)))

    i0, i1, w0, w1 = taps(h, shape[0])
    rows = fma(w1[:, None], image[i1], image[i0] * w0[:, None])
    i0, i1, w0, w1 = taps(w, shape[1])
    return rows[:, i0] * w0 + rows[:, i1] * w1


def build_pyramid(image: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2) -> list[torch.Tensor]:
    """Chained 1/scale resizes from the previous level (like the reference)."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[lvl]))
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    k /= k.sum()
    return tuple(float(v) for v in k)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur, reflect-101 border (OpenCV's default)."""
    k = np.asarray(_gaussian_kernel_1d(ksize, sigma), np.float32)
    half = ksize // 2
    h, w = image.shape
    padded = F.pad(image[None, None], (half, half, half, half), mode="reflect")[0, 0]

    def taps(shifted):
        # k0*x0 + k1*x1 fuses the first product; each later tap is one fma
        acc = fma(float(k[0]), shifted(0), shifted(1) * float(k[1]))
        for i in range(2, ksize):
            acc = fma(float(k[i]), shifted(i), acc)
        return acc

    rows = taps(lambda i: padded[:, i : i + w])
    return taps(lambda i: rows[i : i + h])
