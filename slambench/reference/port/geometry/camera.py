"""Pinhole camera with radial-tangential distortion
(port of weiner_slamit_v2_tpu/geometry/camera.py: ``Camera`` with
``undistort_points`` and ``distort_normalized``, and ``undistorted_bounds``)."""

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

    def distort_normalized(self, xn: torch.Tensor) -> torch.Tensor:
        """Radtan distortion of normalized coordinates (..., 2), one rounding
        per operation (the JAX function run op by op)."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], -1)

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


