"""Fundamental matrix from two poses (port of
weiner_slamit_v2_tpu/geometry/epipolar.py; LocalMapping::ComputeF12,
src/LocalMapping.cc:590-607)."""

from __future__ import annotations

import torch

from . import se3


def fundamental_from_poses(T1w, T2w, K1, K2) -> torch.Tensor:
    """F12 with x1^T F12 x2 = 0 for corresponding rectified pixels."""
    R1w, t1w = T1w[..., :3, :3], T1w[..., :3, 3]
    R2w, t2w = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = -(R12 @ t2w[..., None])[..., 0] + t1w
    E = se3.hat(t12) @ R12
    return torch.linalg.inv(K1).transpose(-1, -2) @ E @ torch.linalg.inv(K2)
