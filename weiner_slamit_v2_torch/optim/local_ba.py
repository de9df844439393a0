"""Bundle adjustment: Levenberg-Marquardt with blocked Schur complement
(port of weiner_slamit_v2_tpu/optim/local_ba.py: the resumable ``ba_phase1``
/ ``ba_phase2_chunk`` / ``ba_finalize`` and their composition ``solve_ba``;
Optimizer::LocalBundleAdjustment, src/Optimizer.cc:453-778).

An observation with a stereo right-u adds the row u - bf/z - ur
(EdgeStereoSE3ProjectXYZ, Optimizer.cc:274-310); its chi2 gate and Huber
delta^2 are 7.815 instead of 5.991. A problem without ``obs_ur`` (None)
runs the monocular computation, unchanged.

The observation layout is point-major (P, O). The JAX package gathers poses
and reduces camera blocks with one-hot matmuls (a TPU workaround); here they
are direct gathers and ``util.index_add`` scatters (the same sums on every
run). The reduced camera system is solved by Cholesky.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geometry import se3
from ..util import index_add

CHI2_MONO = 5.991
CHI2_STEREO = 7.815  # 3-dof 95% gate (Optimizer.cc:295)
HUBER2 = 5.991       # Huber delta^2 (Optimizer.cc:536)
BA_LAMBDA_INIT = 1e-4


@dataclass
class BAProblem:
    cam_pose: torch.Tensor       # (C, 4, 4)
    cam_fixed: torch.Tensor      # (C,) bool
    cam_valid: torch.Tensor      # (C,) bool
    points: torch.Tensor         # (P, 3)
    point_valid: torch.Tensor    # (P,) bool
    obs_cam: torch.Tensor        # (P, O) i32 cam slot or -1
    obs_uv: torch.Tensor         # (P, O, 2)
    obs_inv_sigma2: torch.Tensor  # (P, O)
    obs_valid: torch.Tensor      # (P, O) bool
    K: torch.Tensor              # (3, 3)
    # stereo observations: right-image u per observation and its mask, and
    # baseline x fx; None for a monocular problem (the row is left out)
    obs_ur: torch.Tensor | None = None       # (P, O)
    obs_has_ur: torch.Tensor | None = None   # (P, O) bool
    bf: torch.Tensor | None = None           # ()


@dataclass
class BAResult:
    cam_pose: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor     # (P, O) bool
    final_cost: torch.Tensor


def _project(cam_pose, points, K, obs_cam, obs_uv):
    """Per-observation camera-frame point, residuals; (P, O) planes."""
    T = cam_pose[obs_cam.clamp(min=0).long()]                 # (P, O, 4, 4)
    R, t = T[..., :3, :3], T[..., :3, 3]
    Xc = (R @ points[:, None, :, None])[..., 0] + t            # (P, O, 3)
    x, y, z = Xc.unbind(-1)
    iz = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    ru = K[0, 0] * x * iz + K[0, 2] - obs_uv[..., 0]
    rv = K[1, 1] * y * iz + K[1, 2] - obs_uv[..., 1]
    return R, x, y, z, iz, ru, rv


def _robust_weight(chi2, robust: bool, huber2=HUBER2):
    if not robust:
        return torch.ones_like(chi2)
    return torch.where(chi2 <= huber2, 1.0, torch.sqrt(huber2 / torch.clamp(chi2, min=1e-12)))


def _robust_cost(chi2, robust: bool, huber2=HUBER2):
    if not robust:
        return chi2
    return torch.where(chi2 <= huber2, chi2,
                       2.0 * torch.sqrt(huber2 * torch.clamp(chi2, min=1e-12)) - huber2)


def _per_obs_chi2_th(prob, chi2_mono=CHI2_MONO):
    """The chi2 gate, also the Huber delta^2: 7.815 for a stereo
    observation, ``chi2_mono`` for the others."""
    if prob.obs_has_ur is None:
        return chi2_mono
    return torch.where(prob.obs_has_ur, CHI2_STEREO, chi2_mono)


def _finite(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def build_normal_equations(cam_pose, points, K, obs_cam, obs_uv, w, obs_ur=None,
                           obs_has_ur=None, bf=None):
    """Hcc (C,6,6), bc (C,6), Hpp (P,3,3), bp (P,3), U (6C, 3P); the stereo
    row's products join every block with the same weight."""
    C = cam_pose.shape[0]
    P, O = w.shape
    fx, fy = K[0, 0], K[1, 1]
    R, x, y, z, iz, ru, rv = _project(cam_pose, points, K, obs_cam, obs_uv)
    wf = w * (z > 0)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2,
                      fx * (1.0 + x * x * iz2), -fx * y * iz], -1)         # (P,O,6)
    Jv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1.0 + y * y * iz2),
                      fy * x * y * iz2, fy * x * iz], -1)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)                   # dproj/dXc
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    Jpu = (du[..., None, :] @ R)[..., 0, :]                                 # (P,O,3)
    Jpv = (dv[..., None, :] @ R)[..., 0, :]
    wv = wf[..., None, None]
    outer = lambda a, b: a[..., :, None] * b[..., None, :]  # noqa: E731
    Hpp = (outer(Jpu, Jpu) + outer(Jpv, Jpv)) * wv
    bp = (Jpu * ru[..., None] + Jpv * rv[..., None]) * wf[..., None]
    Hcc_o = (outer(Ju, Ju) + outer(Jv, Jv)) * wv
    bc_o = (Ju * ru[..., None] + Jv * rv[..., None]) * wf[..., None]
    G = (outer(Ju, Jpu) + outer(Jv, Jpv)) * wv
    if obs_ur is not None:
        # u_r = u - bf/z: d(u_r) = du + (bf/z^2) dz, dz/dxi = (0, 0, 1, y, -x, 0),
        # dz/dX = R's third row
        rur = ru + obs_uv[..., 0] - bf * iz - obs_ur
        g = bf * iz2
        Jur = Ju + g[..., None] * torch.stack([zero, zero, torch.ones_like(x), y, -x, zero], -1)
        Jpur = Jpu + g[..., None] * R[..., 2, :]
        wur = wf * obs_has_ur
        wuv = wur[..., None, None]
        Hpp = Hpp + outer(Jpur, Jpur) * wuv
        bp = bp + Jpur * rur[..., None] * wur[..., None]
        Hcc_o = Hcc_o + outer(Jur, Jur) * wuv
        bc_o = bc_o + Jur * rur[..., None] * wur[..., None]
        G = G + outer(Jur, Jpur) * wuv
    Hpp = _finite(Hpp).sum(1)
    bp = -_finite(bp).sum(1)
    Hcc_o = _finite(Hcc_o).reshape(P * O, 36)
    bc_o = _finite(bc_o).reshape(P * O, 6)
    cam = obs_cam.clamp(min=0).long().reshape(-1)
    pidx = torch.arange(P, device=w.device).repeat_interleave(O)
    # an empty observation slot (camera -1, all zeros) goes to a spare row of
    # its own point: on the card one camera row with all of them would be
    # summed one value after another (util.index_add)
    row = torch.where(obs_cam.reshape(-1) >= 0, cam, C + pidx)
    Hcc = index_add(torch.zeros((C + P, 36), device=w.device), row, Hcc_o)[:C].reshape(C, 6, 6)
    bc = -index_add(torch.zeros((C + P, 6), device=w.device), row, bc_o)[:C]
    G = _finite(G).reshape(P * O, 18)
    U5 = index_add(torch.zeros((P * C, 18), device=w.device), pidx * C + cam, G)
    U = U5.reshape(P, C, 6, 3).permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    return Hcc, bc, Hpp, bp, U


def _inv3x3(A):
    """Batched closed-form 3x3 inverse with a relative determinant clamp."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    scale = torch.clamp(a.abs() + e.abs() + i.abs(), min=1e-12)
    det_min = 1e-7 * scale * scale * scale
    det = torch.where(det.abs() < det_min, torch.sign(det + 1e-30) * det_min, det)
    adj = torch.stack([torch.stack([A11, A12, A13], -1), torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


def schur_solve(Hcc, bc, Hpp, bp, U, cam_free, point_free, lam, reduce=None):
    """Damped normal equations solved by marginalizing points.
    ``reduce(S, b_red) -> (S, b_red)``: the sum of the reduced camera system
    over the ranks that each hold a block of the points (the distributed BA,
    parallel/sharded_ba.py; JAX's psum), applied after each rank added its
    own damped camera blocks. Returns (dc (C,6), dp (P,3))."""
    C, P = Hcc.shape[0], Hpp.shape[0]
    eye3 = torch.eye(3, device=Hcc.device)
    eye6 = torch.eye(6, device=Hcc.device)
    Hcc_d = Hcc + (lam * torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6))[..., None] * eye6
    Hpp_d = Hpp + (lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6))[..., None] * eye3
    Hpp_d = torch.where(point_free[:, None, None], Hpp_d, eye3)
    bp = torch.where(point_free[:, None], bp, 0.0)
    pmask = point_free[:, None].expand(P, 3).reshape(P * 3)
    U = torch.where(pmask[None, :], U, 0.0)
    Hpp_inv = _inv3x3(Hpp_d)
    Q = (U.reshape(C * 6, P, 1, 3) @ Hpp_inv[None]).reshape(C * 6, P * 3)
    S = -(Q @ U.T)
    b_red = bc.reshape(C * 6) - Q @ bp.reshape(P * 3)
    S = S.reshape(C, 6, C, 6).permute(0, 2, 1, 3).clone()
    ar = torch.arange(C, device=Hcc.device)
    S[ar, ar] += Hcc_d
    b_red = b_red.reshape(C, 6)
    if reduce is not None:
        S, b_red = reduce(S, b_red)
    free = cam_free
    S = torch.where((free[:, None] & free[None, :])[:, :, None, None], S, 0.0)
    S[ar, ar] += torch.where(free, 0.0, 1.0)[:, None, None] * eye6
    b_red = torch.where(free[:, None], b_red, 0.0)
    S_dense = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6) + 1e-8 * torch.eye(C * 6, device=Hcc.device)
    L, _ = torch.linalg.cholesky_ex(S_dense)
    dc = torch.cholesky_solve(b_red.reshape(-1, 1), L).reshape(C, 6)
    dc = torch.where(free[:, None], dc, 0.0)
    rhs = bp - (U.T @ dc.reshape(C * 6)).reshape(P, 3)
    dp = (Hpp_inv @ rhs[..., None])[..., 0]
    return dc, torch.where(point_free[:, None], dp, 0.0)


def _total_cost(cam_pose, points, prob: BAProblem, active_obs, robust: bool):
    _, x, _, z, iz, ru, rv = _project(cam_pose, points, prob.K, prob.obs_cam, prob.obs_uv)
    r2 = ru * ru + rv * rv
    if prob.obs_ur is not None:
        K = prob.K
        rur = (K[0, 0] * x * iz + K[0, 2] - prob.bf * iz) - prob.obs_ur
        r2 = r2 + torch.where(prob.obs_has_ur, rur * rur, 0.0)
    chi2 = r2 * prob.obs_inv_sigma2
    ok = active_obs & (z > 0)
    return torch.where(ok, _robust_cost(chi2, robust, _per_obs_chi2_th(prob)), 0.0).sum(), chi2, z


def _base_obs(prob: BAProblem):
    return (prob.obs_valid & (prob.obs_cam >= 0) & prob.point_valid[:, None]
            & prob.cam_valid[prob.obs_cam.clamp(min=0).long()])


def _lm_phase(prob, cam_pose, points, active_obs, robust: bool, n_iters: int, lam, reduce=None):
    """``n_iters`` LM steps. With ``reduce`` (a sum over ranks, see
    schur_solve) the problem holds one rank's block of points: the reduced
    system, both costs and the count of non-finite point steps are summed,
    so every rank takes the same accept decision."""
    cam_free = prob.cam_valid & ~prob.cam_fixed
    point_free = prob.point_valid & (_base_obs(prob).sum(1) > 0)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=points.device)
    for _ in range(n_iters):
        c0, chi2, _ = _total_cost(cam_pose, points, prob, active_obs, robust)
        w = torch.where(active_obs, prob.obs_inv_sigma2
                        * _robust_weight(chi2, robust, _per_obs_chi2_th(prob)), 0.0)
        Hcc, bc, Hpp, bp, U = build_normal_equations(
            cam_pose, points, prob.K, prob.obs_cam, prob.obs_uv, w, prob.obs_ur,
            prob.obs_has_ur, prob.bf)
        dc, dp = schur_solve(Hcc, bc, Hpp, bp, U, cam_free, point_free, lam, reduce)
        new_pose = se3.retract(cam_pose, dc)
        new_pts = points + dp
        c1, _, _ = _total_cost(new_pose, new_pts, prob, active_obs, robust)
        if reduce is None:
            dp_finite = torch.isfinite(dp).all()
        else:
            c0, c1, n_bad = reduce(c0, c1, (~torch.isfinite(dp)).sum())
            dp_finite = n_bad == 0
        accept = (c1 < c0) & torch.isfinite(c1) & torch.isfinite(dc).all() & dp_finite
        cam_pose = torch.where(accept, new_pose, cam_pose)
        points = torch.where(accept, new_pts, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0), 1e-5, 1e3)
    return cam_pose, points, lam


# The resumable pieces of the schedule: the reference's LocalBundleAdjustment
# quits between LM iterations when mbAbortBA is set (g2o setForceStopFlag,
# src/Optimizer.cc:617-640, src/LocalMapping.cc:127,681-684); here the
# schedule is cut into calls so the caller can stop issuing chunks at any
# boundary and finalize from the best state so far.

def ba_phase1(prob: BAProblem, n_iters: int = 5, chi2_th: float = CHI2_MONO,
              lambda_init: float = BA_LAMBDA_INIT):
    """Robust phase + outlier classification (Optimizer.cc:617-655).
    Returns (cam_pose, points, lam, inlier (P,O))."""
    base = _base_obs(prob)
    cam_pose, points, lam = _lm_phase(prob, prob.cam_pose, prob.points, base, True, n_iters,
                                      lambda_init)
    _, chi2, z = _total_cost(cam_pose, points, prob, base, True)
    return cam_pose, points, lam, base & (chi2 <= _per_obs_chi2_th(prob, chi2_th)) & (z > 0)


def ba_phase2_chunk(prob: BAProblem, cam_pose, points, lam, inlier, n_iters: int = 5):
    """One non-robust refinement chunk over the inlier set; feed the outputs
    back in for the next chunk. Returns (cam_pose, points, lam)."""
    return _lm_phase(prob, cam_pose, points, inlier, False, n_iters, lam)


def ba_finalize(prob: BAProblem, cam_pose, points, chi2_th: float = CHI2_MONO) -> BAResult:
    """Orthonormalize and classify inliers from any intermediate state (the
    abort path adopts the best state so far, as the reference writes back
    after an interrupted optimize, Optimizer.cc:700-778)."""
    base = _base_obs(prob)
    cam_pose = se3.orthonormalize(cam_pose)
    final_cost, chi2, z = _total_cost(cam_pose, points, prob, base, False)
    return BAResult(cam_pose=cam_pose, points=points,
                    obs_inlier=base & (chi2 <= _per_obs_chi2_th(prob, chi2_th)) & (z > 0),
                    final_cost=final_cost)


def solve_ba(prob: BAProblem, iters1: int = 5, iters2: int = 10,
             chi2_th: float = CHI2_MONO, lambda_init: float = BA_LAMBDA_INIT) -> BAResult:
    """Two-phase LM (Optimizer.cc:617-680) in one call: the three pieces
    above with the refinement as one chunk, so a staged pass whose chunks all
    ran (the first restarting at lambda_init) computes the same numbers."""
    cam_pose, points, _, inlier = ba_phase1(prob, iters1, chi2_th, lambda_init)
    cam_pose, points, _ = ba_phase2_chunk(prob, cam_pose, points, lambda_init, inlier, iters2)
    return ba_finalize(prob, cam_pose, points, chi2_th)
