"""FAST-9/16 score + 3x3 non-max suppression, plain PyTorch (port of
weiner_slamit_v2_tpu/ops/fast.py; the per-cell cv::FAST calls of
src/ORBextractor.cc:778-873).

The score is the largest threshold at which a pixel is still a corner: the
max over the 16 circular 9-arcs of the min ring difference, bright and dark
sides. Detecting once at threshold 0 serves both FAST thresholds (20 / 7)
downstream (ops/topk_grid.py). ``ops/fast_kernel.py`` holds the fused CUDA
kernel; these functions are its plain twin.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9


def _arc_min(diffs: torch.Tensor) -> torch.Tensor:
    """max over the 16 circular windows of the min over 9 entries; diffs
    (16, H, W) -> (H, W)."""
    m3 = torch.minimum(torch.minimum(diffs, diffs.roll(-1, 0)), diffs.roll(-2, 0))
    m9 = torch.minimum(torch.minimum(m3, m3.roll(-3, 0)), m3.roll(-6, 0))
    return m9.amax(0)


def fast_score(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST response: score where score > threshold, else 0; the
    3-px border is 0."""
    ring = torch.stack([image.roll((-dy, -dx), (0, 1)) for dy, dx in CIRCLE])
    center = image[None]
    score = torch.maximum(_arc_min(ring - center), _arc_min(center - ring))
    h, w = image.shape
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where((score > threshold) & interior, score, 0.0)


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """Strict > against the 4 raster-earlier neighbours, >= against the 4
    later ones: exactly one pixel survives on a plateau."""
    keep = score > 0
    for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1)):
        keep &= score > score.roll((-dy, -dx), (0, 1))
    for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
        keep &= score >= score.roll((-dy, -dx), (0, 1))
    return torch.where(keep, score, 0.0)
