"""Batched two-view triangulation (port of
weiner_slamit_v2_tpu/geometry/triangulate.py): inhomogeneous DLT with
closed-form 3x3 normal equations (Initializer::Triangulate,
src/Initializer.cc:743-805)."""

from __future__ import annotations

import torch


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """P = K [R|t]: K (3,3), Tcw (...,4,4) -> (...,3,4)."""
    return K @ Tcw[..., :3, :4]


def triangulate_dlt(uv1, uv2, P1, P2) -> torch.Tensor:
    """uv1, uv2 (..., 2) rectified pixels; P1, P2 (3,4) or (...,3,4).
    Returns (..., 3) world points."""
    P1 = P1.expand(*uv1.shape[:-1], 3, 4)
    P2 = P2.expand(*uv2.shape[:-1], 3, 4)
    rows = torch.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        -2,
    )
    B = rows[..., :3]
    a = rows[..., 3]
    H = B.transpose(-1, -2) @ B
    g = -(B.transpose(-1, -2) @ a[..., None])[..., 0]
    h00, h01, h02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    h11, h12, h22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det = torch.where(det.abs() < 1e-18, torch.sign(det + 1e-30) * 1e-18, det)
    x = (c00 * g[..., 0] + c01 * g[..., 1] + c02 * g[..., 2]) / det
    y = (c01 * g[..., 0] + c11 * g[..., 1] + c12 * g[..., 2]) / det
    z = (c02 * g[..., 0] + c12 * g[..., 1] + c22 * g[..., 2]) / det
    return torch.stack([x, y, z], -1)


def depth_in_view(Tcw: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """z of world points X (...,3) in the camera frame of Tcw."""
    return (Tcw[..., 2, :3] * X).sum(-1) + Tcw[..., 2, 3]


def parallax_cos(C1, C2, X) -> torch.Tensor:
    """Cosine of the ray angle at X between centers C1, C2
    (Initializer::CheckRT, src/Initializer.cc:866-886)."""
    n1 = X - C1
    n2 = X - C2
    d = torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1)
    return (n1 * n2).sum(-1) / torch.clamp(d, min=1e-12)


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """World-frame camera center -R^T t (batched)."""
    R = Tcw[..., :3, :3]
    return -(R.transpose(-1, -2) @ Tcw[..., :3, 3:4])[..., 0]
