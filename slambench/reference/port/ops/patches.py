"""Keypoint patches and in-patch sampling as direct indexing (port of
weiner_slamit_v2_tpu/ops/patches.py, whose row gather + one-hot matmul form
is a TPU workaround, weiner_slamit_v2_tpu/ops/patches.py:1-20)."""

from __future__ import annotations

import torch


def extract_patches(image: torch.Tensor, xy: torch.Tensor, half: int) -> torch.Tensor:
    """(N, 2*half+1, 2*half+1) patches around rounded keypoint coords
    (clamped to the image; valid keypoints keep a 19-px margin)."""
    h, w = image.shape
    d = torch.arange(-half, half + 1, device=image.device)
    x0 = torch.round(xy[:, 0]).long()
    y0 = torch.round(xy[:, 1]).long()
    yy = (y0[:, None] + d[None, :]).clamp(0, h - 1)
    xx = (x0[:, None] + d[None, :]).clamp(0, w - 1)
    return image[yy[:, :, None], xx[:, None, :]]


def sample_in_patch(patches: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """patches (N, P, P) centred at (half, half); sx, sy (N, S) integer
    offsets. Returns (N, S) values patches[n, half + sy, half + sx]."""
    n, p, _ = patches.shape
    half = (p - 1) // 2
    ry = (sy + half).clamp(0, p - 1)
    rx = (sx + half).clamp(0, p - 1)
    rows = torch.arange(n, device=patches.device)[:, None]
    return patches[rows, ry, rx]
