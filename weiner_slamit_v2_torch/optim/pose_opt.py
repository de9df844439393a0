"""Motion-only pose optimization: Levenberg-Marquardt on SE(3) (port of
weiner_slamit_v2_tpu/optim/pose_opt.py, monocular rows;
Optimizer::PoseOptimization, src/Optimizer.cc:239-451): 4 rounds x 10 LM
iterations, Huber delta sqrt(5.991) in rounds 0-1, chi2 reclassification
between rounds."""

from __future__ import annotations

import torch

from ..geometry import se3

CHI2_MONO = 5.991


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD 6x6 damped normal system by Cholesky. The JAX package
    unrolls the factorization into scalar ops for the TPU; here it is one
    batched LAPACK/cuSOLVER call that never syncs (a failed factorization
    yields non-finite steps, which the LM acceptance test rejects)."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _residuals_jacobian(Tcw, X, uv, fx, fy, cx, cy):
    """(ru, rv, Ju (6,N), Jv (6,N), z): residuals and Jacobian rows of the
    left-multiplicative tangent [upsilon, omega]."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    x = R[0, 0] * X[:, 0] + R[0, 1] * X[:, 1] + R[0, 2] * X[:, 2] + t[0]
    y = R[1, 0] * X[:, 0] + R[1, 1] * X[:, 1] + R[1, 2] * X[:, 2] + t[1]
    z = R[2, 0] * X[:, 0] + R[2, 1] * X[:, 1] + R[2, 2] * X[:, 2] + t[2]
    iz = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    iz2 = iz * iz
    ru = fx * x * iz + cx - uv[:, 0]
    rv = fy * y * iz + cy - uv[:, 1]
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2,
                      fx * (1.0 + x * x * iz2), -fx * y * iz])
    Jv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1.0 + y * y * iz2),
                      fy * x * y * iz2, fy * x * iz])
    return ru, rv, Ju, Jv, z


def optimize_pose(Tcw0, X, uv, inv_sigma2, valid, K, n_rounds: int = 4,
                  n_iters: int = 10, chi2_th: float = CHI2_MONO,
                  lambda_init: float = 1e-3):
    """Optimize one pose against fixed points X (N,3) observed at uv (N,2).
    Returns (Tcw (4,4), inliers (N,) bool, n_inliers ())."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    delta2 = CHI2_MONO
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)

    def chi2_of(Tcw):
        ru, rv, _, _, z = _residuals_jacobian(Tcw, X, uv, fx, fy, cx, cy)
        return (ru * ru + rv * rv) * inv_sigma2, z

    def robust_cost(chi2, z, mask, robust):
        rho = chi2
        if robust:
            rho = torch.where(chi2 <= delta2, chi2,
                              2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
        return torch.where(mask & (z > 0), rho, 0.0).sum()

    Tcw, inliers = Tcw0, valid
    for rnd in range(n_rounds):
        robust = rnd < 2   # robust kernel off from round 2 (Optimizer.cc:432)
        lam = torch.tensor(lambda_init, dtype=torch.float32, device=Tcw0.device)
        for _ in range(n_iters):
            ru, rv, Ju, Jv, z = _residuals_jacobian(Tcw, X, uv, fx, fy, cx, cy)
            chi2 = (ru * ru + rv * rv) * inv_sigma2
            wr = torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
            w = inv_sigma2 * (wr if robust else 1.0)
            w = torch.where(inliers & (z > 0), w, 0.0)
            Juw, Jvw = Ju * w, Jv * w
            H = Juw @ Ju.T + Jvw @ Jv.T
            b = -(Juw @ ru + Jvw @ rv)
            cost0 = robust_cost(chi2, z, inliers, robust)
            dx = solve6(H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6, b)
            T_new = se3.retract(Tcw, dx)
            c_new, z_new = chi2_of(T_new)
            cost1 = robust_cost(c_new, z_new, inliers, robust)
            accept = (cost1 < cost0) & torch.isfinite(cost1) & torch.isfinite(dx).all()
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
        chi2, z = chi2_of(Tcw)
        inliers = valid & (chi2 <= chi2_th) & (z > 0)
    return se3.orthonormalize(Tcw), inliers, inliers.sum()
