"""Pinhole camera with radial-tangential distortion
(port of weiner_slamit_v2_tpu/geometry/camera.py: ``Camera``,
``undistort_points``, ``distort_normalized``, ``project``, ``unproject``,
``image_bounds``, ``in_image``, ``undistorted_bounds``,
``bounds_from_config``, ``pixel4_camera``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..util import device_const, fma


def _tangential(xc: torch.Tensor, y: torch.Tensor, c_cross: float, c_t: float, ct, t):
    """``xc * y + ct * t``, fused as XLA:CPU's compiled program fuses it: the
    LLVM it emits turns a product with a negative constant into a
    subtraction of the negated product, and a subtracted product is never
    the one fused, so the cross term ``xc * y`` is fused unless its
    coefficient ``c_cross`` alone is negative."""
    if c_cross < 0 <= c_t:
        return fma(ct, t, xc * y)
    return fma(xc, y, ct * t)


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

    def distort_normalized(self, xn: torch.Tensor) -> torch.Tensor:
        """Radtan distortion of normalized coordinates (..., 2), one rounding
        per operation (the JAX function run op by op)."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], -1)

    def project(self, X_cam: torch.Tensor, distort: bool = False) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2); rectified unless
        ``distort`` (the reference projects rectified pixels everywhere after
        keypoint undistortion)."""
        z = X_cam[..., 2]
        z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
        xn = X_cam[..., :2] / z_safe[..., None]
        if distort:
            xn = self.distort_normalized(xn)
        return torch.stack([self.fx * xn[..., 0] + self.cx, self.fy * xn[..., 1] + self.cy], -1)

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Rectified pixels (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x * depth, y * depth, depth], -1)

    def undistort_points(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Distorted pixels (..., 2) -> rectified pixels (..., 2): the
        reference's fixed-point iteration (Frame::UndistortKeyPoints,
        src/Frame.cc:529-559), rounded as the tracker's compiled JAX program
        rounds it (the camera's fields are constants there). XLA divides by
        ``fx`` as a product with its float32 reciprocal and folds the first
        pass's ``x * 2 p`` into ``(u - cx) * (2 p / fx)``; LLVM fuses
        ``x * x + y * y`` (``y * y + x * x`` for the first pass's y), ``r2 +
        2 x * x``, the whole radial Horner chain, one product of each
        tangential sum (``_tangential``) and the final ``f * x + c``."""
        vals = (self.fx, self.fy, self.cx, self.cy, self.k1, self.k2, self.k3, self.p1, self.p2)
        f32 = np.float32
        rfx, rfy = f32(1) / f32(self.fx), f32(1) / f32(self.fy)
        p1x2, p2x2 = f32(2 * self.p1), f32(2 * self.p2)

        def make(d):
            c32 = [self.cx, self.cy, rfx, rfy, rfx * p1x2, rfx * p2x2, p1x2, p2x2]
            c64 = [self.fx, self.fy, self.cx, self.cy, self.k1, self.k2, self.k3, self.p1, self.p2, 1.0]
            return (torch.tensor(np.asarray(c32, f32), device=d).unbind()
                    + torch.tensor(c64, dtype=torch.float64, device=d).unbind())

        (cx, cy, rfx_t, rfy_t, rfx_p1x2, rfx_p2x2, p1x2_t, p2x2_t,
         fx, fy, cx64, cy64, k1, k2, k3, p1, p2, one) = device_const(("undistort", vals), uv.device, make)
        ux, uy = uv[..., 0] - cx, uv[..., 1] - cy
        x0, y0 = ux * rfx_t, uy * rfy_t
        x, y = x0, y0
        if any(v != 0.0 for v in (self.k1, self.k2, self.k3, self.p1, self.p2)):
            for it in range(iters):
                r2x = fma(x, x, y * y)
                # the first pass's y column adds the squares the other way round
                r2y = fma(y, y, x * x) if it == 0 else r2x
                rad_x = fma(r2x, fma(r2x, fma(r2x, k3, k2), k1), one)
                rad_y = fma(r2y, fma(r2y, fma(r2y, k3, k2), k1), one) if it == 0 else rad_x
                xp1, xp2 = (ux * rfx_p1x2, ux * rfx_p2x2) if it == 0 else (x * p1x2_t, x * p2x2_t)
                dx = _tangential(xp1, y, self.p1, self.p2, p2, fma(x, x + x, r2x))
                dy = _tangential(xp2, y, self.p2, self.p1, p1, fma(y, y + y, r2y))
                x, y = (x0 - dx) / rad_x, (y0 - dy) / rad_y
        return torch.stack([fma(fx, x, cx64), fma(fy, y, cy64)], -1)

    def image_bounds(self) -> np.ndarray:
        """Undistorted image bounds [min_x, max_x, min_y, max_y]
        (Frame::ComputeImageBounds, src/Frame.cc:561-589)."""
        return undistorted_bounds(self.fx, self.fy, self.cx, self.cy, self.k1, self.k2,
                                  self.p1, self.p2, self.k3, self.width, self.height)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        """Mask of pixels inside the (rectified) image rectangle."""
        u, v = uv[..., 0], uv[..., 1]
        return ((u >= margin) & (u < self.width - margin)
                & (v >= margin) & (v < self.height - margin))


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


def pixel4_camera() -> Camera:
    """The reference app's hardcoded Pixel-4 calibration
    (jni/ORB_SLAM2/src/Tracking.cc:76-105)."""
    return Camera.create(
        fx=526.69, fy=540.36, cx=313.07, cy=238.39,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480,
    )
