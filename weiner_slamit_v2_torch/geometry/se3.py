"""SE(3) rigid-transform operations (port of weiner_slamit_v2_tpu/geometry/se3.py).

Conventions are the reference's: a pose is a 4x4 world->camera matrix
``Tcw``; tangent vectors are ``[upsilon, omega]`` (g2o SE3Quat order); every
function broadcasts over leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import xla_math
from ..util import fma

_EPS = 1e-8


def _eye(n, like: torch.Tensor, shape=()) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(*shape, n, n)


def hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched)."""
    z = torch.zeros_like(omega[..., 0])
    w0, w1, w2 = omega[..., 0], omega[..., 1], omega[..., 2]
    return torch.stack(
        [
            torch.stack([z, -w2, w1], -1),
            torch.stack([w2, z, -w0], -1),
            torch.stack([-w1, w0, z], -1),
        ],
        -2,
    )


# float32 constants of the small-angle series: XLA folds ``theta2 / 6.0``
# into a product with the rounded reciprocal
_INV6 = float(np.float32(1.0 / 6.0))
_INV24 = float(np.float32(1.0 / 24.0))
_INV120 = float(np.float32(1.0 / 120.0))


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B (batched) as XLA:CPU's elemental dot computes a small product:
    each output a chain of fused multiply-adds over k = 0, 1, ..., from the
    first product alone. torch's matmul sums in the order of its BLAS (on
    the card, cuBLAS's), which parts from it by an ulp on most 3x3
    products."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        out = fma(A[..., :, k:k + 1], B[..., k:k + 1, :], out)
    return out


def _coeffs(omega: torch.Tensor):
    """(a, b, c, K, K @ K) of the Rodrigues forms, in the roundings of the
    JAX package's jitted ``exp`` (XLA:CPU, ``--xla_cpu_max_isa=AVX2``):
    theta2 a fused chain, sqrt correctly rounded, sin and cos glibc's
    (``ops/xla_math.py``), the series' products fused into their
    differences."""
    w0, w1, w2 = omega[..., 0], omega[..., 1], omega[..., 2]
    theta2 = fma(w2, w2, fma(w1, w1, w0 * w0))
    theta = xla_math.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    sin, cos = xla_math.sincos(theta)
    a = torch.where(big, sin / theta, fma(-theta2, _INV6, 1.0))
    b = torch.where(big, (1.0 - cos) / theta2, fma(-theta2, _INV24, 0.5))
    c = torch.where(big, (theta - sin) / (theta2 * theta), fma(-theta2, _INV120, _INV6))
    K = hat(omega)
    return a, b, c, K, matmul(K, K)


def _rodrigues(p, q, K, KK):
    """I + p K + q K @ K, each entry two fused multiply-adds."""
    eye = _eye(3, K, K.shape[:-2])
    return fma(q[..., None, None], KK, fma(p[..., None, None], K, eye))


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: 3-vector -> 3x3 rotation matrix (batched)."""
    a, b, _, K, KK = _coeffs(omega)
    return _rodrigues(a, b, K, KK)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 3-vector (batched), by atan2 of (sin, cos): finite
    derivatives at the identity, where pose-graph residuals start."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_theta = 0.5 * torch.sqrt((vee * vee).sum(-1) + _EPS * _EPS)
    theta = torch.atan2(sin_theta, cos_theta)
    scale = torch.where(sin_theta > _EPS, theta / (2.0 * torch.clamp(sin_theta, min=_EPS)),
                        0.5 + theta * theta / 12.0)
    return vee * scale[..., None]


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: exp([u, w]) has translation V @ u."""
    _, b, c, K, KK = _coeffs(omega)
    return _rodrigues(b, c, K, KK)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: [upsilon, omega] -> 4x4 (batched), bit-equal to
    the JAX package's jitted ``exp`` on the CPU and on the card."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    a, b, c, K, KK = _coeffs(omega)
    t = matmul(_rodrigues(b, c, K, KK), upsilon[..., None])[..., 0]
    return from_rt(_rodrigues(a, b, K, KK), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: 4x4 -> [upsilon, omega] (batched)."""
    omega = so3_log(T[..., :3, :3])
    V = _left_jacobian(omega)
    upsilon = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]   # no host check
    return torch.cat([upsilon, omega], -1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 from rotation (...,3,3) and translation (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(*batch, 3, 3), t.expand(*batch, 3)[..., None]], -1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]   # made on the device: no host copy
    return torch.cat([top, bottom.expand(*batch, 1, 4)], -2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (batched)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -matmul(Rt, T[..., :3, 3:4])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Transform points: (...,4,4) x (...,3) -> (...,3)."""
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o VertexSE3Expmap::oplusImpl)."""
    return matmul(exp(xi), T)


def orthonormalize(T: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Newton-Schulz)."""
    R = T[..., :3, :3]
    eye = _eye(3, T, R.shape[:-2])
    for _ in range(iters):
        R = matmul(0.5 * R, 3.0 * eye - matmul(R.transpose(-1, -2), R))
    return from_rt(R, T[..., :3, 3])


def quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [qx, qy, qz, qw] (Shepperd)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    tr = m00 + m11 + m22

    def cand(diag, build):
        q = torch.sqrt(torch.clamp(diag, min=_EPS)) * 0.5
        return build(q, 0.25 / torch.clamp(q, min=_EPS))

    c0 = cand(1.0 + tr, lambda q, s: torch.stack(
        [(m21 - m12) * s, (m02 - m20) * s, (m10 - m01) * s, q], -1))
    c1 = cand(1.0 + m00 - m11 - m22, lambda q, s: torch.stack(
        [q, (m01 + m10) * s, (m02 + m20) * s, (m21 - m12) * s], -1))
    c2 = cand(1.0 - m00 + m11 - m22, lambda q, s: torch.stack(
        [(m01 + m10) * s, q, (m12 + m21) * s, (m02 - m20) * s], -1))
    c3 = cand(1.0 - m00 - m11 + m22, lambda q, s: torch.stack(
        [(m02 + m20) * s, (m12 + m21) * s, q, (m10 - m01) * s], -1))
    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    q = torch.where(use0, c0, torch.where(use1, c1, torch.where(use2, c2, c3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [qx, qy, qz, qw] -> rotation matrix (batched)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
