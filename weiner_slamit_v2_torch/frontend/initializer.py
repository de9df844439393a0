"""Monocular two-view bootstrap: parallel H/F RANSAC + model selection + SfM
(port of weiner_slamit_v2_tpu/frontend/initializer.py; Initializer,
src/Initializer.cc).

The RANSAC sample draws are an argument: the tracker draws them from a
``torch.Generator`` seeded with ``cfg.seed + frame_id``; the tests feed the
JAX package's own draws so both run the same hypotheses.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geometry import se3, triangulate

N_RANSAC = 200        # Initializer.cc:86-106
SAMPLE_SIZE = 8
SIGMA = 1.0
TH_H = 5.991          # Initializer.cc:342
TH_F = 3.841          # Initializer.cc:417
TH_SCORE = 5.991      # Initializer.cc:418
RH_THRESHOLD = 0.40   # Initializer.cc:121-124
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
CHECK_RT_TH2 = 4.0    # Initializer.cc:866-910


@dataclass
class InitResult:
    success: torch.Tensor        # () bool
    Tcw2: torch.Tensor           # (4, 4)
    points: torch.Tensor         # (M, 3)
    is_point: torch.Tensor       # (M,) bool
    n_good: torch.Tensor         # () int
    used_homography: torch.Tensor  # () bool


def draw_samples(n_valid: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """(N_RANSAC, SAMPLE_SIZE) int64 draws in [0, max(n_valid, 1))."""
    return torch.randint(0, max(int(n_valid), 1), (N_RANSAC, SAMPLE_SIZE),
                         generator=generator).to(device)


def _normalize(uv, valid):
    """Mean / mean-abs-dev normalization (Initializer.cc:758-804)."""
    w = valid.float()
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    dev = ((uv - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    T = torch.eye(3, dtype=uv.dtype, device=uv.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (uv - mean) * s, T


def _solve_h(uv1, uv2):
    """Batched DLT homographies from 8 correspondences: (R,8,2) -> (R,3,3)."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ra = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    rb = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    _, _, vt = torch.linalg.svd(torch.cat([ra, rb], -2), full_matrices=True)
    return vt[..., 8, :].reshape(-1, 3, 3)


def _solve_f(uv1, uv2):
    """Batched 8-point fundamentals with rank-2 projection."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], -1)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    F = vt[..., 8, :].reshape(-1, 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ torch.diag_embed(S) @ Vt


def _score_h(H21, uv1, uv2, valid, inv_sigma2):
    """Symmetric transfer error scoring (Initializer.cc:314-397), batched
    over hypotheses H21 (R,3,3)."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], 1)
        p = ah @ H.transpose(-1, -2)
        w = torch.where(p[..., 2].abs() < 1e-9, 1e-9, p[..., 2])
        return ((p[..., :2] / w[..., None] - b) ** 2).sum(-1)

    chi2_1 = transfer(H12, uv2, uv1) * inv_sigma2
    chi2_2 = transfer(H21, uv1, uv2) * inv_sigma2
    ok1, ok2 = chi2_1 < TH_H, chi2_2 < TH_H
    score = torch.where(valid & ok1, TH_H - chi2_1, 0.0) + torch.where(valid & ok2, TH_H - chi2_2, 0.0)
    return score.sum(-1), valid & ok1 & ok2


def _score_f(F21, uv1, uv2, valid, inv_sigma2):
    """Point-to-epipolar-line chi2 scoring (Initializer.cc:399-477)."""

    def line_dist2(F, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], 1)
        l = ah @ F.transpose(-1, -2)
        num = l[..., 0] * b[:, 0] + l[..., 1] * b[:, 1] + l[..., 2]
        den = l[..., 0] ** 2 + l[..., 1] ** 2
        return num * num / torch.clamp(den, min=1e-12)

    chi2_1 = line_dist2(F21, uv1, uv2) * inv_sigma2
    chi2_2 = line_dist2(F21.transpose(-1, -2), uv2, uv1) * inv_sigma2
    ok1, ok2 = chi2_1 < TH_F, chi2_2 < TH_F
    score = torch.where(valid & ok1, TH_SCORE - chi2_1, 0.0) + torch.where(valid & ok2, TH_SCORE - chi2_2, 0.0)
    return score.sum(-1), valid & ok1 & ok2


def _check_rt(Rs, ts, uv1, uv2, valid, K, sigma2):
    """Cheirality + reprojection + parallax check, batched over (R, t)
    hypotheses (Initializer.cc:807-916). Returns (n_good, parallax_deg,
    points, good) with a leading hypothesis dim."""
    T2 = se3.from_rt(Rs, ts)
    T1 = torch.eye(4, dtype=Rs.dtype, device=Rs.device)
    P1 = triangulate.projection_matrix(K, T1)
    P2 = triangulate.projection_matrix(K, T2)
    nh = Rs.shape[0]
    X = triangulate.triangulate_dlt(
        uv1.expand(nh, -1, -1), uv2.expand(nh, -1, -1), P1, P2[:, None]
    )
    finite = torch.isfinite(X).all(-1)
    C2 = triangulate.camera_center(T2)
    cosp = triangulate.parallax_cos(torch.zeros(3, device=Rs.device), C2[:, None], X)
    z1 = X[..., 2]
    z2 = triangulate.depth_in_view(T2[:, None], X)
    enough_parallax = cosp < 0.99998
    cheirality = torch.where(enough_parallax, (z1 > 0) & (z2 > 0), True)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err2(Xc, uv):
        zs = torch.where(Xc[..., 2].abs() < 1e-9, 1e-9, Xc[..., 2])
        u = fx * Xc[..., 0] / zs + cx
        v = fy * Xc[..., 1] / zs + cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    th2 = CHECK_RT_TH2 * sigma2
    good = (valid & finite & cheirality & (reproj_err2(X, uv1) < th2)
            & (reproj_err2(se3.apply(T2[:, None], X), uv2) < th2) & (z1 > 0) & (z2 > 0))
    n_good = good.sum(-1)
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), -1).values
    k = torch.clamp(torch.clamp(n_good - 1, min=0), max=49)
    parallax = torch.rad2deg(torch.arccos(cos_sorted.gather(-1, k[:, None])[:, 0].clamp(-1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, 0.0)
    return n_good, parallax, X, good


def _decompose_e(E):
    """4 (R, t) hypotheses from an essential matrix (Initializer.cc:918-940)."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    t = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(A):
    """Faugeras & Lustman 8-solution decomposition of A = K^-1 H K
    (Initializer.cc:581-705)."""
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sin_th = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_th = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sin_ph = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_ph = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], device=A.device)
    z, o = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for i in range(4):
        st = signs[i] * sin_th
        Rp = torch.stack([torch.stack([cos_th, z, -st]), torch.stack([z, o, z]),
                          torch.stack([st, z, cos_th])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ (torch.stack([x1s[i], z, -x3s[i]]) * (d1 - d3)))
    for i in range(4):
        sp = signs[i] * sin_ph
        Rp = torch.stack([torch.stack([cos_ph, z, sp]), torch.stack([z, -o, z]),
                          torch.stack([sp, z, -cos_ph])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ (torch.stack([x1s[i], z, x3s[i]]) * (d1 + d3)))
    ts = torch.stack(ts)
    return torch.stack(Rs), ts / torch.clamp(torch.linalg.norm(ts, dim=1, keepdim=True), min=1e-12)


def _select_hypothesis(Rs, ts, uv1, uv2, valid, K, n_inliers, second_best_factor, sigma2):
    """CheckRT on every hypothesis + the reference's acceptance gates."""
    n_goods, parallaxes, Xs, goods = _check_rt(Rs, ts, uv1, uv2, valid, K, sigma2)
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    hyp = torch.arange(Rs.shape[0], device=Rs.device)
    n_second = torch.where(hyp == best, -1, n_goods).max()
    n_min = torch.clamp((0.9 * n_inliers).to(torch.int32), min=MIN_TRIANGULATED)
    ok = (n_best >= n_min) & (n_second < second_best_factor * n_best) & (parallaxes[best] > MIN_PARALLAX_DEG)
    return ok, se3.from_rt(Rs[best], ts[best]), Xs[best], goods[best], n_best


def initialize_two_view(uv1, uv2, valid, K, draws, sigma2=None) -> InitResult:
    """Two-view bootstrap from matched rectified pixels uv1, uv2 (M, 2),
    mask valid (M,), intrinsics K (3,3) and RANSAC draws (N_RANSAC, 8) in
    [0, max(n_valid, 1)). sigma2 (M,): per-match octave noise scale."""
    M = uv1.shape[0]
    if sigma2 is None:
        sigma2 = torch.ones(M, dtype=uv1.dtype, device=uv1.device)
    inv_sigma2 = 1.0 / sigma2
    n_valid = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid first
    sample_idx = order[draws.to(uv1.device).long()]
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    s1, s2 = uv1n[sample_idx], uv2n[sample_idx]
    H21s = torch.linalg.inv(T2) @ _solve_h(s1, s2) @ T1
    F21s = T2.T @ _solve_f(s1, s2) @ T1
    h_scores, h_masks = _score_h(H21s, uv1, uv2, valid, inv_sigma2)
    f_scores, f_masks = _score_f(F21s, uv1, uv2, valid, inv_sigma2)
    bh, bf = torch.argmax(h_scores), torch.argmax(f_scores)
    SH, SF = h_scores[bh], f_scores[bf]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > RH_THRESHOLD
    h_inl, f_inl = h_masks[bh], f_masks[bf]

    Rs_h, ts_h = _decompose_h(torch.linalg.inv(K) @ H21s[bh] @ K)
    res_h = _select_hypothesis(Rs_h, ts_h, uv1, uv2, h_inl, K, h_inl.sum(), 0.75, sigma2)
    Rs_f, ts_f = _decompose_e(K.T @ F21s[bf] @ K)
    res_f = _select_hypothesis(Rs_f, ts_f, uv1, uv2, f_inl, K, f_inl.sum(), 0.7, sigma2)
    ok, Tcw2, pts, is_point, n_good = (torch.where(use_h, a, b) for a, b in zip(res_h, res_f))
    return InitResult(success=ok & (n_valid >= SAMPLE_SIZE), Tcw2=Tcw2, points=pts,
                      is_point=is_point, n_good=n_good, used_homography=use_h)
