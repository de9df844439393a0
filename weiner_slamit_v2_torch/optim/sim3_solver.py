"""Sim3 from 3D-3D correspondences: Horn's method, RANSAC and Gauss-Newton
refinement (port of weiner_slamit_v2_tpu/optim/sim3_solver.py; Sim3Solver,
src/Sim3Solver.cc, and Optimizer::OptimizeSim3, src/Optimizer.cc:1046-1217).

All RANSAC hypotheses are one batch of 4x4 ``eigh`` solves. The draws are an
argument, as for the initializer and PnP: ``ransac_sim3`` takes the
(N_ITERS, 3) sample indices into the valid matches (``draw_samples`` makes
them from a ``torch.Generator``; tests feed the JAX package's draws).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..geometry import se3, sim3

SAMPLE = 3            # 3-point minimal sets (Sim3Solver.cc:166)
N_ITERS = 300         # RANSAC budget (LoopClosing.cc:286)
CHI2 = 9.210          # inlier gate per reprojection (Sim3Solver.cc:87-88)


def draw_samples(n_valid: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """(N_ITERS, SAMPLE) int64 indices into the first ``n_valid`` matches."""
    return torch.randint(0, max(int(n_valid), 1), (N_ITERS, SAMPLE),
                         generator=generator).to(device)


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool = False) -> torch.Tensor:
    """Closed-form similarity S12 with P1 ~= s R P2 + t (Horn 1987, the
    quaternion method of Sim3Solver::ComputeSim3), batched over leading
    dims of (..., N, 3). The eigenvector's sign is free; S12 is not."""
    O1, O2 = P1.mean(-2), P2.mean(-2)
    Pr1, Pr2 = P1 - O1[..., None, :], P2 - O2[..., None, :]
    M = Pr2.transpose(-1, -2) @ Pr1
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = (M[..., i, :].unbind(-1) for i in range(3))
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = torch.linalg.eigh(N)[1][..., :, -1]          # largest eigenvalue: [w, x, y, z]
    R = se3.rot_from_quat(torch.cat([q[..., 1:], q[..., :1]], -1))
    P3 = Pr2 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones_like(O1[..., 0])
    else:
        s = (Pr1 * P3).sum((-1, -2)) / torch.clamp((P3 * P3).sum((-1, -2)), min=1e-12)
    t = O1 - s[..., None] * (R @ O2[..., None])[..., 0]
    return sim3.from_rts(R, t, s)


def _project(K, P):
    z = torch.where(P[..., 2].abs() < 1e-9, 1e-9, P[..., 2])
    uv = torch.stack([K[0, 0] * P[..., 0] / z + K[0, 2], K[1, 1] * P[..., 1] / z + K[1, 2]], -1)
    return uv, P[..., 2]


def ransac_sim3(X1, X2, valid, uv1, uv2, inv_sigma2_1, inv_sigma2_2, K, draws,
                fix_scale: bool = False):
    """RANSAC Sim3 between two keyframes' matched points. X1, X2 (N, 3) in
    camera 1 / camera 2; uv1, uv2 their observed keypoints; draws (I, 3)
    indices into the valid matches. Inliers pass the mutual reprojection
    chi2 gate (Sim3Solver::CheckInliers, Sim3Solver.cc:340-379). Returns
    (S12 (4, 4), inliers (N,), n_inliers)."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)    # jnp.argsort is stable
    sample = order[draws.long()]                                   # (I, 3)
    Ss = horn_sim3(X1[sample], X2[sample], fix_scale)              # (I, 4, 4)
    S21 = sim3.inv(Ss)
    p2_in_1, z1 = _project(K, sim3.apply(Ss[:, None], X2[None]))
    p1_in_2, z2 = _project(K, sim3.apply(S21[:, None], X1[None]))
    e1 = ((p2_in_1 - uv1) ** 2).sum(-1) * inv_sigma2_1
    e2 = ((p1_in_2 - uv2) ** 2).sum(-1) * inv_sigma2_2
    inls = valid & (e1 < CHI2) & (e2 < CHI2) & (z1 > 0) & (z2 > 0)
    counts = inls.sum(1)
    finite = torch.isfinite(Ss.reshape(Ss.shape[0], -1)).all(1)
    counts = torch.where(finite, counts, -1)
    best = torch.argmax(counts)       # the first maximum, as jnp.argmax
    return Ss[best], inls[best], torch.clamp(counts[best], min=0)


def refine_sim3(S12, X1, X2, valid, uv1, uv2, inv_sigma2_1, inv_sigma2_2, K,
                n_iters: int = 10, chi2_th: float = 10.0, fix_scale: bool = False):
    """Gauss-Newton over the forward and backward projections, n_iters // 2
    steps, then the edges past chi2_th dropped, then the rest (the schedule
    of Optimizer::OptimizeSim3). The Jacobian is forward-mode autodiff of the
    residual in the tangent space (jacfwd, as the JAX package). Returns
    (S12, inliers (N,), n_inliers)."""
    def residuals(xi, S):
        Sc = sim3.exp(xi) @ S
        p1, z1 = _project(K, sim3.apply(Sc, X2))
        p2, z2 = _project(K, sim3.apply(sim3.inv(Sc), X1))
        return p1 - uv1, p2 - uv2, z1, z2

    # the tangent as a (1, 7) batch: under forward-mode AD a where over 0-dim
    # operands gives float64 tangents
    zero = torch.zeros((1, 7), dtype=X1.dtype, device=X1.device)
    w_oct = torch.cat([inv_sigma2_1, inv_sigma2_2])

    def chi2s(S):
        r1, r2, z1, z2 = residuals(zero, S)
        return (r1 * r1).sum(1) * inv_sigma2_1, (r2 * r2).sum(1) * inv_sigma2_2, z1, z2

    def gn_step(S, active):
        J = jacfwd(lambda xi: torch.cat(residuals(xi, S)[:2], 0))(zero)[:, :, 0]   # (2N, 2, 7)
        r = torch.cat(residuals(zero, S)[:2], 0)
        w = w_oct * torch.cat([active, active]).to(w_oct.dtype)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J) + 1e-5 * torch.eye(7, device=J.device)
        b = -torch.einsum("nij,ni->j", Jw, r)
        dx = torch.linalg.solve_ex(H, b)[0]
        if fix_scale:
            dx = torch.cat([dx[:6], dx.new_zeros(1)])
        S_new = sim3.exp(dx[None])[0] @ S
        return torch.where(torch.isfinite(S_new).all(), S_new, S)

    def gate(S):
        c1, c2, z1, z2 = chi2s(S)
        return valid & (c1 <= chi2_th) & (c2 <= chi2_th) & (z1 > 0) & (z2 > 0)

    S = S12
    for _ in range(n_iters // 2):
        S = gn_step(S, valid)
    active = gate(S)
    for _ in range(n_iters - n_iters // 2):
        S = gn_step(S, active)
    inl = gate(S)
    return S, inl, inl.sum()
