"""ORB feature extraction: pyramid -> FAST -> select -> orient -> describe
(port of weiner_slamit_v2_tpu/frontend/extractor.py;
ORBextractor::operator(), src/ORBextractor.cc:1064-1136).

Frozen copy for the benchmark's reference: kernel A is its plain form
(FAST score at threshold 0, then the 3x3 NMS, level by level); the output is the fixed-size, padded ``FrameFeatures`` set.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import OrbConfig
from ..ops import orb, pyramid, topk_grid
from ..ops.fast import fast_score, nms_3x3
from ..ops.pattern import EDGE_MARGIN, HALF_PATCH
from ..ops.patches import extract_patches


def fast_score_nms_levels(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel A's plain form: the NMS'd FAST score of every level."""
    return [nms_3x3(fast_score(img, 0.0)) for img in levels]


@dataclass
class FrameFeatures:
    """Fixed-size per-frame feature set (the Frame keypoint vectors)."""

    xy: torch.Tensor        # (N, 2) f32 level-0 pixels (raw)
    xy_und: torch.Tensor    # (N, 2) f32 undistorted
    response: torch.Tensor  # (N,) f32
    angle: torch.Tensor     # (N,) f32 radians
    octave: torch.Tensor    # (N,) i32
    desc: torch.Tensor      # (N, 8) i32 bit patterns
    valid: torch.Tensor     # (N,) bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def replace(self, **kw) -> "FrameFeatures":
        return dataclasses.replace(self, **kw)

    def take(self, idx: torch.Tensor) -> "FrameFeatures":
        """Row subset (every field indexed by ``idx``)."""
        return FrameFeatures(**{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)})


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level budgets, remainder to the coarsest level
    (ORBextractor.cc:444-455)."""
    inv = 1.0 / scale_factor
    total = (1.0 - inv**n_levels) / (1.0 - inv)
    per0 = n_features / total
    budgets = [int(round(per0 * inv**l)) for l in range(n_levels - 1)]
    budgets.append(max(n_features - sum(budgets), 0))
    return budgets


class OrbExtractor:
    """Stateless extractor with static per-level metadata."""

    def __init__(self, cfg: OrbConfig, image_hw: tuple[int, int]):
        self.cfg = cfg
        self.image_hw = image_hw
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.scales = pyramid.scale_factors(cfg.n_levels, cfg.scale_factor)
        self.sigma2 = (self.scales**2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.n_total = sum(self.budgets)

    def __call__(self, image: torch.Tensor) -> FrameFeatures:
        """image: (H, W) grayscale, uint8 or float32 in [0, 255]."""
        return self.extract_levels(
            pyramid.build_pyramid(image.to(torch.float32), self.cfg.n_levels, self.cfg.scale_factor)
        )

    def extract_levels(self, levels: list[torch.Tensor]) -> FrameFeatures:
        """Features from an already built pyramid."""
        cfg = self.cfg
        used = [lvl for lvl in range(len(levels)) if self.budgets[lvl] > 0]
        # threshold-0 fused FAST+NMS of every used level in one kernel launch
        # (each level's score depends on that level alone); select_keypoints
        # applies the low threshold itself (NMS commutes with a monotone
        # threshold)
        scores = fast_score_nms_levels([levels[lvl].contiguous() for lvl in used])
        parts, ori_patches, brief_patches = [], [], []
        for lvl, score in zip(used, scores):
            img, budget = levels[lvl], self.budgets[lvl]
            xy, resp, valid = topk_grid.select_keypoints(
                score, budget=budget, cell_size=cfg.cell_size,
                high_threshold=cfg.fast_threshold, low_threshold=cfg.fast_min_threshold,
                margin=EDGE_MARGIN,
            )
            ori_patches.append(extract_patches(img, xy, HALF_PATCH))
            brief_patches.append(extract_patches(pyramid.gaussian_blur(img), xy, HALF_PATCH))
            octv = torch.full((budget,), lvl, dtype=torch.int32, device=img.device)
            parts.append((xy * float(self.scales[lvl]), resp, octv, valid))
        # orientation and BRIEF of every level at once (each keypoint's
        # result depends on its own patch alone)
        ang = orb.patch_orientations(torch.cat(ori_patches))
        desc = orb.patch_descriptors(torch.cat(brief_patches), ang)
        xy, resp, octv, valid = (torch.cat(p) for p in zip(*parts))
        return FrameFeatures(xy=xy, xy_und=xy, response=resp, angle=ang,
                             octave=octv, desc=desc, valid=valid)


