"""RANSAC PnP for relocalization: batched 6-point DLT hypotheses + inlier
voting (port of weiner_slamit_v2_tpu/optim/pnp.py; the role of PnPsolver,
src/PnPsolver.cc, with the reference's RANSAC parameters, Tracking.cc:1694).

The sample draws are an argument, (N_ITERS, SAMPLE) indices into the valid
rows, as for the initializer: the tracker draws them from a seeded
``torch.Generator`` and the tests feed the JAX package's own draws.
"""

from __future__ import annotations

import torch

from ..geometry import se3

N_ITERS = 300        # Tracking.cc:1694 (RANSAC max iterations)
SAMPLE = 6           # 6-point DLT minimal set (the reference uses 4-point EPnP)
CHI2 = 5.991         # th2 (Tracking.cc:1694)


def draw_samples(n_valid: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """(N_ITERS, SAMPLE) int64 draws in [0, max(n_valid, 1))."""
    return torch.randint(0, max(int(n_valid), 1), (N_ITERS, SAMPLE),
                         generator=generator).to(device)


def _solve_dlt(Xw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Batched 6-point DLT in normalized camera coordinates: Xw (B, 6, 3),
    xn (B, 6, 2) -> Tcw (B, 4, 4) with an orthonormal rotation. The null
    vector's sign is free; the signed scale below fixes it."""
    B = Xw.shape[0]
    zeros = torch.zeros((B, SAMPLE, 4), dtype=Xw.dtype, device=Xw.device)
    Xh = torch.cat([Xw, torch.ones((B, SAMPLE, 1), dtype=Xw.dtype, device=Xw.device)], -1)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], -1)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)
    _, _, vt = torch.linalg.svd(torch.cat([rows_u, rows_v], -2))     # (B, 12, 12)
    P = vt[:, -1].reshape(B, 3, 4)
    U, S, Vt = torch.linalg.svd(P[..., :3])
    R = U @ Vt
    neg = torch.linalg.det(R) < 0
    R = torch.where(neg[:, None, None], -R, R)
    scale = S.mean(-1) * torch.where(neg, -1.0, 1.0)
    t = P[..., 3] / torch.where(scale.abs() < 1e-12, 1e-12, scale)[:, None]
    return se3.from_rt(R, t)


def ransac_pnp(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               inv_sigma2: torch.Tensor, K: torch.Tensor, draws: torch.Tensor,
               chi2_th: float = CHI2):
    """RANSAC pose from 2D-3D matches: X (N,3) world points, uv (N,2)
    rectified pixels, valid (N,), inv_sigma2 (N,), draws (I, 6) indices into
    the valid rows. Returns (Tcw (4,4), inlier mask (N,), n_inliers ()); the
    caller applies the acceptance gate and refines with optimize_pose."""
    N = X.shape[0]
    order = torch.argsort((~valid).to(torch.uint8), stable=True)   # valid rows first
    sample_idx = order[draws.to(X.device).long()]                  # (I, 6)
    uvh = torch.cat([uv, torch.ones((N, 1), dtype=uv.dtype, device=uv.device)], 1)
    xn = (uvh @ torch.linalg.inv(K).T)[:, :2]
    Ts = _solve_dlt(X[sample_idx], xn[sample_idx])                 # (I, 4, 4)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Pc = (Ts[:, None, :3, :3] @ X[None, :, :, None])[..., 0] + Ts[:, None, :3, 3]
    z = Pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * Pc[..., 0] / zs + cx
    v = fy * Pc[..., 1] / zs + cy
    chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    inls = valid & (z > 0) & (chi2 < chi2_th)                      # (I, N)
    counts = inls.sum(1)
    counts = torch.where(torch.isfinite(Ts.reshape(Ts.shape[0], -1)).all(1), counts, -1)
    best = torch.argmax(counts)
    return Ts[best], inls[best], counts[best].clamp(min=0)
