"""Fundamental matrix from two poses and the epipolar distance (port of
weiner_slamit_v2_tpu/geometry/epipolar.py; LocalMapping::ComputeF12,
src/LocalMapping.cc:590-607, and ORBmatcher::CheckDistEpipolarLine)."""

from __future__ import annotations

import torch

from ..util import fma
from . import se3


def fundamental_from_poses(T1w, T2w, K1, K2) -> torch.Tensor:
    """F12 with x1^T F12 x2 = 0 for corresponding rectified pixels."""
    R1w, t1w = T1w[..., :3, :3], T1w[..., :3, 3]
    R2w, t2w = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = -(R12 @ t2w[..., None])[..., 0] + t1w
    E = se3.hat(t12) @ R12
    return torch.linalg.inv(K1).transpose(-1, -2) @ E @ torch.linalg.inv(K2)


def epipolar_dist_sq(uv1: torch.Tensor, uv2: torch.Tensor, F12: torch.Tensor) -> torch.Tensor:
    """Squared distance of ``uv1`` from the epipolar line ``F12 @ [uv2, 1]``
    (batched): CheckDistEpipolarLine's formula (src/ORBmatcher.cc:142-159)."""
    # the line F12 @ [u2, v2, 1] summed as XLA:CPU's dot sums it: the first
    # product, then each later one fused into the running sum
    u2, v2 = uv2[..., None, 0], uv2[..., None, 1]
    line = F12[..., 2] + fma(F12[..., 1], v2, F12[..., 0] * u2)
    num = line[..., 0] * uv1[..., 0] + line[..., 1] * uv1[..., 1] + line[..., 2]
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / den.clamp(min=1e-12)
