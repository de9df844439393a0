"""Pinhole camera with radial-tangential distortion
(port of weiner_slamit_v2_tpu/geometry/camera.py: ``Camera``,
``undistort_points``, ``unproject``, ``undistorted_bounds``,
``bounds_from_config``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..util import device_const, fma


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480

    @classmethod
    def create(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               width=640, height=480) -> "Camera":
        f = lambda v: float(np.float32(v))  # noqa: E731  (float32 intrinsics)
        return cls(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2), f(k3),
                   int(width), int(height))

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Rectified pixels (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x * depth, y * depth, depth], -1)

    def undistort_points(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Distorted pixels (..., 2) -> rectified pixels (..., 2): the same
        fixed-point iteration as the reference (Frame::UndistortKeyPoints,
        src/Frame.cc:529-559). The final ``f * x + c`` is one fused
        multiply-add, as the reference's compiled program evaluates it."""
        vals = (self.fx, self.fy, self.cx, self.cy, self.k1, self.k2, self.k3, self.p1, self.p2)
        fx, fy, cx, cy, k1, k2, k3, p1, p2 = device_const(
            ("undistort", vals), uv.device,
            lambda d: torch.tensor(vals, dtype=torch.float32, device=d).unbind())
        d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
        x = d
        if any(v != 0.0 for v in (self.k1, self.k2, self.k3, self.p1, self.p2)):
            for _ in range(iters):
                xx, yy = x[..., 0], x[..., 1]
                r2 = xx * xx + yy * yy
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
                dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
                x = (d - torch.stack([dx, dy], -1)) / radial[..., None]
        return torch.stack([fma(fx, x[..., 0], cx), fma(fy, x[..., 1], cy)], -1)


def undistorted_bounds(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                       width=640, height=480) -> np.ndarray:
    """Frame::ComputeImageBounds (src/Frame.cc:561-589): the four image
    corners through the undistortion; [min_x, max_x, min_y, max_y] float32."""
    if k1 == 0 and k2 == 0 and p1 == 0 and p2 == 0 and k3 == 0:
        return np.asarray([0.0, float(width), 0.0, float(height)], np.float32)
    corners = np.array([[0, 0], [width, 0], [0, height], [width, height]], np.float64)
    xd = (corners[:, 0] - cx) / fx
    yd = (corners[:, 1] - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    u = fx * x + cx
    v = fy * y + cy
    return np.asarray(
        [min(u[0], u[2]), max(u[1], u[3]), min(v[0], v[1]), max(v[2], v[3])], np.float32
    )


def bounds_from_config(cam_cfg) -> np.ndarray:
    """undistorted_bounds from a config.CameraConfig."""
    return undistorted_bounds(
        cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
        cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3,
        cam_cfg.width, cam_cfg.height,
    )
