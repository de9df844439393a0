"""Image pyramid + Gaussian blur (port of weiner_slamit_v2_tpu/ops/pyramid.py;
ORBextractor::ComputePyramid, src/ORBextractor.cc:1138-1168, and the 7x7
sigma=2 blur of src/ORBextractor.cc:1117).

FAST compares exact pixel differences, so one ulp in a pyramid level moves
keypoints. Both operations therefore reproduce the reference's compiled
float32 arithmetic operation for operation instead of calling
``F.interpolate`` or a convolution (which would also run through
cuDNN/TF32 on the card), and every level of every image size the repo
ships is bit-equal to it (tests/test_torch_frontend.py::test_pyramid_levels):

* resize: ``jax.image.resize(linear, antialias=False)`` is two dots with
  half-pixel triangle weights (rows first, then columns). The weights are
  computed as the compiled weight loop computes them: the sample coordinate
  ``(j + 0.5) * (m / n) - 0.5`` is one fused multiply-add where the loop
  runs, a rounded product and a rounded difference where LLVM unrolled it
  and folded the constant (``_sample_coords``). Each output has two
  nonzero taps, summed in the form XLA:CPU's GEMM library gives it: the
  chain ``fma(w1, x1, w0 * x0)`` or the rounded sum ``w0 * x0 + w1 * x1``,
  per output, from the measured table of ops/resize_forms.py (the form
  depends on the library's blocking of each dot, not on (m, n) alone).
* blur: separable, reflect-101 border, ordered shifted multiply-adds:
  ``fma(k0, x0, k1 * x1)``, then ``acc = fma(k[i], x[i], acc)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import resize_forms
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


# The compiled weight loop runs 8 lanes wide. LLVM unrolls it fully up to 11
# vector iterations (n < 96), and always unrolls the scalar remainder; an
# unrolled iteration's sample coordinate is a constant, folded as a rounded
# product then a rounded difference. The other iterations run, and compute
# it as one fused multiply-add.
_LANES = 8
_UNROLLED_BELOW = 96


def _sample_coords(m: int, n: int) -> np.ndarray:
    """(n,) float32 sample coordinates ``(j + 0.5) * (m / n) - 0.5`` as the
    reference's compiled weight computation evaluates each."""
    inv = np.float32(1.0 / (n / m))
    base = np.arange(n, dtype=np.float32) + np.float32(0.5)
    fused = (base.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    folded = base * inv - np.float32(0.5)
    j = np.arange(n)
    return np.where((n < _UNROLLED_BELOW) | (j >= n // _LANES * _LANES), folded, fused)


@functools.lru_cache(maxsize=None)
def _taps(m: int, n: int):
    """Two-tap linear resize weights for one axis, size m -> n, computed as
    jax.image.resize computes its weight matrix (float32 throughout)."""
    sf = _sample_coords(m, n)
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


def _pass_consts(axis: int, m: int, n: int, other: int, device) -> tuple[torch.Tensor, ...]:
    """Tap indices, weights and chain-form mask of one resize pass."""
    def make(d):
        i0, i1, w0, w1 = _taps(m, n)
        chain = resize_forms.chain_mask(axis, m, n, other)
        return tuple(torch.from_numpy(a).to(d) for a in (i0, i1, w0, w1, chain))
    return device_const(("resize_pass", axis, m, n, other), device, make)


def _two_taps(x0, x1, w0, w1, chain) -> torch.Tensor:
    """Each output's two taps in the form its pass gives it: the chain
    ``fma(w1, x1, w0 * x0)`` or the rounded sum ``w0 * x0 + w1 * x1``."""
    p0 = x0 * w0
    return torch.where(chain, fma(w1, x1, p0), p0 + x1 * w1)


def resize_linear(image: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 -> shape, bit-equal to the reference's resize at the
    sizes ``resize_forms.FORMS`` holds."""
    h, w = image.shape
    i0, i1, w0, w1, chain = _pass_consts(0, h, shape[0], w, image.device)
    rows = _two_taps(image[i0], image[i1], w0[:, None], w1[:, None], chain[:, None])
    i0, i1, w0, w1, chain = _pass_consts(1, w, shape[1], shape[0], image.device)
    return _two_taps(rows[:, i0], rows[:, i1], w0, w1, chain)


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
