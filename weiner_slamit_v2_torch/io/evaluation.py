"""Trajectory evaluation: ATE RMSE (with Sim3/SE3 alignment) and RPE.

The reference has no eval harness (validation was manual on-device —
SURVEY.md §4); this module provides the standard TUM-RGBD-benchmark-style
metrics the BASELINE targets are expressed in.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N, 3) corresponding points.
      with_scale: estimate scale (monocular trajectories) or fix s=1.

    Returns: (R (3,3), t (3,), s) with dst ~= s * R @ src + t.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_Twc: np.ndarray,
    gt_Twc: np.ndarray,
    align_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE after Sim3 (or SE3) alignment.

    Both inputs are (N, 4, 4) camera-to-world pose arrays in frame-by-frame
    correspondence.
    """
    p_est = np.asarray(est_Twc, dtype=np.float64)[:, :3, 3]
    p_gt = np.asarray(gt_Twc, dtype=np.float64)[:, :3, 3]
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale=align_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = aligned - p_gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def rpe_rmse(
    est_Twc: np.ndarray, gt_Twc: np.ndarray, delta: int = 1
) -> tuple[float, float]:
    """Relative pose error RMSE over frame pairs (i, i+delta).

    Returns (translational RMSE, rotational RMSE in radians).
    """
    est = np.asarray(est_Twc, dtype=np.float64)
    gt = np.asarray(gt_Twc, dtype=np.float64)
    n = len(est) - delta
    terr = np.zeros(n)
    rerr = np.zeros(n)
    for i in range(n):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        terr[i] = np.linalg.norm(e[:3, 3])
        cos = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr[i] = np.arccos(cos)
    return float(np.sqrt((terr**2).mean())), float(np.sqrt((rerr**2).mean()))
