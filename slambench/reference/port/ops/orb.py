"""Keypoint orientation + rotated BRIEF-256 descriptors (port of
weiner_slamit_v2_tpu/ops/orb.py; IC_Angle and
computeOrbDescriptor, src/ORBextractor.cc:82-152).

Both are bit-equal to the reference's compiled program: the intensity
moments are summed in the order of XLA:CPU's vectorized reduce, the angle
and its sine and cosine come from ``xla_math`` (the C library's float
functions the compiled program calls). Descriptors pack to (N, 8) int32 bit
patterns.
"""

from __future__ import annotations

import torch

from . import pattern as pat
from . import xla_math
from ..util import device_const, fma
from .patches import sample_in_patch


# XLA:CPU's reduce of an (N, 31, 31) product over (1, 2): rows 0-27 run in
# 4 lanes (lane l takes rows l, l+4, ..., l+24, each row's 31 columns in
# order, one fused multiply-add each; lane 0 starts at +0, lanes 1-3 at -0),
# the lanes combine as (l0 + l2) + (l1 + l3), then rows 28-30 follow one
# multiply-add at a time.
_LANES = 4
_LANE_ROWS = 28


def patch_orientations(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation, radians, of (N, 31, 31) patches of the
    (unblurred) level: ``atan2(m01, m10)`` of the disc-masked moments."""
    mask, xs, ys = device_const("orientation_disc", patches.device, lambda d: tuple(
        torch.from_numpy(a).to(d) for a in pat.orientation_disc()))
    # (2, N, 31, 31) exact float64 products of the masked patch and the
    # coordinate: each multiply-add below is the float32 rounding of one sum
    prod = (patches * mask).double()[None] * torch.stack([xs, ys]).double()[:, None]
    n, p = patches.shape[0], patches.shape[1]
    lanes = prod[:, :, :_LANE_ROWS].reshape(2, n, _LANE_ROWS // _LANES, _LANES, p)
    acc = torch.full((2, n, _LANES), -0.0, dtype=torch.float32, device=patches.device)
    acc[..., 0] = 0.0
    # one kernel a step: the sum in float64, stored rounded to float32
    for g in range(_LANE_ROWS // _LANES):
        for c in range(p):
            torch.add(lanes[:, :, g, :, c], acc, out=acc)
    total = (acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3])
    for r in range(_LANE_ROWS, p):
        for c in range(p):
            torch.add(prod[:, :, r, c], total, out=total)
    return xla_math.atan2(total[1], total[0])


def patch_descriptors(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 of (N, 31, 31) patches of the blurred level at the
    keypoints' angles: (N, 8) int32."""
    p = device_const("brief_pattern", patches.device, lambda d: torch.from_numpy(
        pat.brief_pattern().reshape(-1, 2)).to(d).float())
    sa, ca = xla_math.sincos(angle)
    ca, sa = ca[:, None], sa[:, None]
    px, py = p[None, :, 0], p[None, :, 1]
    # steered pattern x' = x cos - y sin, y' = x sin + y cos, each one fused
    # multiply-add as the reference's compiled program evaluates it
    sx = torch.round(fma(px, ca, -(py * sa))).long()
    sy = torch.round(fma(px, sa, py * ca)).long()
    samples = sample_in_patch(patches, sx, sy)
    bits = (samples[:, 0::2] < samples[:, 1::2]).long().reshape(-1, 8, 32)
    words = (bits << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


