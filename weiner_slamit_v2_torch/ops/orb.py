"""Keypoint orientation + rotated BRIEF-256 descriptors (port of
weiner_slamit_v2_tpu/ops/orb.py; IC_Angle and
computeOrbDescriptor, src/ORBextractor.cc:82-152).

Descriptors pack to (N, 8) int32 bit patterns.
"""

from __future__ import annotations

import torch

from . import pattern as pat
from ..util import device_const, fma
from .patches import extract_patches, sample_in_patch


def orientations(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint, radians."""
    mask, xs, ys = device_const("orientation_disc", image.device, lambda d: tuple(
        torch.from_numpy(a).to(d) for a in pat.orientation_disc()))
    patches = extract_patches(image, xy, pat.HALF_PATCH) * mask
    m10 = (patches * xs).sum((1, 2))
    m01 = (patches * ys).sum((1, 2))
    return torch.atan2(m01, m10)


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 on the blurred level: (N, 8) int32."""
    half = pat.HALF_PATCH
    patches = extract_patches(blurred, xy, half)
    p = device_const("brief_pattern", blurred.device, lambda d: torch.from_numpy(
        pat.brief_pattern().reshape(-1, 2)).to(d).float())
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px, py = p[None, :, 0], p[None, :, 1]
    # steered pattern x' = x cos - y sin, y' = x sin + y cos, each one fused
    # multiply-add as the reference's compiled program evaluates it
    sx = torch.round(fma(px, ca, -(py * sa))).long()
    sy = torch.round(fma(px, sa, py * ca)).long()
    samples = sample_in_patch(patches, sx, sy)
    bits = (samples[:, 0::2] < samples[:, 1::2]).long().reshape(-1, 8, 32)
    words = (bits << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
