"""The plain reference of every stage the benchmark judges.

* ``extract``: the frozen copy of the port's front end (``port/``) on the
  frame the benchmark rendered: pyramid, FAST (kernel A's plain form), grid
  selection, orientation, BRIEF, and the undistortion of the keypoints.
* ``pose_lm``: motion-only pose LM (Optimizer::PoseOptimization: 4 rounds x
  10 iterations, Huber in rounds 0-1, chi2 reclassification between rounds,
  the stereo right-u row where a feature has one), in float64.
* ``solve_ba``: the local BA's two-phase LM (robust phase, inlier
  classification, non-robust refinement) on the dense damped normal
  equations, in float64.
* ``ransac_pnp``: the relocalization's RANSAC over 6-point DLT hypotheses
  with the program's draws regenerated from its seed rule, in float64.
* ``windowed_best2``: kernel B's plain form (frozen copy).
* ``stereo_match``: Frame::ComputeStereoMatches keypoint by keypoint, with
  the port's gates: the best descriptor among the right keypoints in the
  row band, disparity range and octave window, then the 11x11 SAD slid
  over +-5 px and the parabola through the best three.
* ``depth_lookup``: Frame::ComputeStereoFromRGBD, the depth image's
  nearest pixel at each keypoint.

``dtype=torch.bfloat16`` is the control: every residual, Jacobian, product
and projection in bfloat16; only the 6x6 / dense / SVD solves run in
float32, which torch offers no bfloat16 form of. Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from .port.frontend.extractor import OrbExtractor
from .port.geometry.camera import Camera
from .port.ops import hamming, pyramid
from .port.ops.match_plain import windowed_best2_plain

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
F64 = torch.float64


def _solve_dtype(dtype):
    return torch.float32 if dtype == torch.bfloat16 else dtype


# --- front end -----------------------------------------------------------------

class FrontEnd:
    """The frozen front end for one configuration (ORB settings, image size,
    lens)."""

    def __init__(self, orb_cfg, camera: dict):
        self.extractor = OrbExtractor(orb_cfg, (camera["height"], camera["width"]))
        self.camera = Camera.create(*(camera[k] for k in ("fx", "fy", "cx", "cy", "k1", "k2",
                                                         "p1", "p2", "k3", "width", "height")))
        self.orb_cfg = orb_cfg
        # the stereo gates as the configuration states them, in float32
        # (Camera.bf; the smallest depth is the baseline, Frame.cc:610)
        bf = float(np.float32(camera.get("baseline_times_fx", 0.0)))
        self.bf = bf
        self.min_z = float(np.float32(bf / camera["fx"] if bf > 0 else 0.0))
        self.scales = torch.from_numpy(self.extractor.scales)

    def __call__(self, image: torch.Tensor, dtype=torch.float32, undistort: bool = True):
        """The features of an (H, W) image; ``undistort=False`` leaves
        ``xy_und`` at ``xy``, as a stereo pair's right view is extracted."""
        levels = pyramid.build_pyramid(image.to(torch.float32), self.orb_cfg.n_levels,
                                       self.orb_cfg.scale_factor)
        if dtype == torch.bfloat16:
            levels = [lv.to(torch.bfloat16).to(torch.float32) for lv in levels]
        feats = self.extractor.extract_levels(levels)
        return feats.replace(xy_und=self.camera.undistort_points(feats.xy)) if undistort else feats


FEATURE_FIELDS = ("xy", "xy_und", "response", "angle", "octave", "desc", "valid")


def feature_diff(a, b) -> int:
    """Entries that differ between two feature sets (every field)."""
    n = 0
    for f in FEATURE_FIELDS:
        x, y = getattr(a, f), getattr(b, f).to(getattr(a, f).device)
        n += int((x != y).sum()) if x.shape == y.shape else x.numel()
    return n


# --- SE(3) -----------------------------------------------------------------------

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """[upsilon, omega] (..., 6) -> (..., 4, 4): R = exp(omega), t = V upsilon."""
    u, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2.clamp(min=1e-30))
    small = th2 < 1e-8
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp(min=1e-30))
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (th2 * th).clamp(min=1e-30))
    K = _hat(w)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ u[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def orthonormalize(T):
    """Nearest rotation (SVD) in the pose's rotation block."""
    U, _, Vh = torch.linalg.svd(T[..., :3, :3].to(F64))
    R = U @ Vh
    out = T.to(F64).clone()
    out[..., :3, :3] = R
    return out


# --- pose LM ---------------------------------------------------------------------

def _pose_resid(T, X, uv, K, ur, bf):
    """Batched over calls: T (B,4,4), X (B,N,3), uv (B,N,2), ur (B,N) or
    None. Returns (ru, rv, rur or None, z, Ju (B,N,6), Jv, Jur or None)."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    Xc = torch.einsum("bij,bnj->bni", R, X) + t[:, None, :]
    x, y, z = Xc.unbind(-1)
    iz = 1.0 / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    iz2 = iz * iz
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ru = fx * x * iz + cx - uv[..., 0]
    rv = fy * y * iz + cy - uv[..., 1]
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2, fx * (1 + x * x * iz2),
                      -fx * y * iz], -1)
    Jv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1 + y * y * iz2), fy * x * y * iz2,
                      fy * x * iz], -1)
    if ur is None:
        return ru, rv, None, z, Ju, Jv, None
    rur = torch.where(ur >= 0, fx * x * iz + cx - bf * iz - ur, zero)
    Jz = torch.stack([zero, zero, torch.ones_like(x), y, -x, zero], -1)
    return ru, rv, rur, z, Ju, Jv, Ju + (bf * iz2)[..., None] * Jz


def pose_chi2(T, X, uv, inv_sigma2, K, ur=None, bf=0.0):
    """(chi2 (B,N), z (B,N)) of every feature at poses T (B,4,4)."""
    ru, rv, rur, z, *_ = _pose_resid(T, X, uv, K, ur, bf)
    c = ru * ru + rv * rv
    if rur is not None:
        c = c + rur * rur
    return c * inv_sigma2, z


def pose_lm(Tcw0, X, uv, inv_sigma2, valid, K, lambda_init, n_rounds=4, n_iters=10, ur=None,
            bf=0.0, chi2_th=CHI2_MONO, dtype=F64):
    """Optimize B poses, each against its fixed points, in one batch: Tcw0
    (B,4,4), X (B,N,3), uv (B,N,2), inv_sigma2 / valid (B,N), lambda_init
    (B,), ur (B,N) or None. Returns (Tcw (B,4,4) float64, inliers (B,N))."""
    dev = X.device
    cast = lambda v: v.to(device=dev, dtype=dtype)  # noqa: E731
    X, uv, w_s, K, T = cast(X), cast(uv), cast(inv_sigma2), cast(K), cast(Tcw0)
    stereo = ur is not None
    if stereo:
        ur = cast(ur)
        is_st = ur >= 0
        delta2 = torch.where(is_st, CHI2_STEREO, CHI2_MONO).to(dtype)
        th = torch.where(is_st, CHI2_STEREO, chi2_th).to(dtype)
    else:
        delta2 = torch.full_like(w_s, CHI2_MONO)
        th = torch.full_like(w_s, chi2_th)
    bf = float(bf)
    sd = _solve_dtype(dtype)
    lam0 = torch.as_tensor(lambda_init, device=dev).to(sd)

    def cost(T, inl, robust):
        chi2, z = pose_chi2(T, X, uv, w_s, K, ur, bf)
        rho = chi2
        if robust:
            rho = torch.where(chi2 <= delta2, chi2,
                              2 * torch.sqrt(delta2 * chi2.clamp(min=1e-12)) - delta2)
        return torch.where(inl & (z > 0), rho, torch.zeros_like(rho)).sum(-1)

    valid = valid.to(dev)
    inl = valid.clone()
    eye6 = torch.eye(6, dtype=sd, device=dev)
    for rnd in range(n_rounds):
        robust = rnd < 2
        lam = lam0.clone()
        for _ in range(n_iters):
            ru, rv, rur, z, Ju, Jv, Jur = _pose_resid(T, X, uv, K, ur, bf)
            chi2 = ru * ru + rv * rv
            if stereo:
                chi2 = chi2 + rur * rur
            chi2 = chi2 * w_s
            wr = torch.where(chi2 <= delta2, torch.ones_like(chi2),
                             torch.sqrt(delta2 / chi2.clamp(min=1e-12)))
            w = w_s * (wr if robust else 1.0)
            w = torch.where(inl & (z > 0), w, torch.zeros_like(w))
            H = (torch.einsum("bni,bn,bnj->bij", Ju, w, Ju)
                 + torch.einsum("bni,bn,bnj->bij", Jv, w, Jv))
            b = -(torch.einsum("bni,bn->bi", Ju, w * ru) + torch.einsum("bni,bn->bi", Jv, w * rv))
            if stereo:
                ws = torch.where(is_st, w, torch.zeros_like(w))
                H = H + torch.einsum("bni,bn,bnj->bij", Jur, ws, Jur)
                b = b - torch.einsum("bni,bn->bi", Jur, ws * rur)
            H, b = H.to(sd), b.to(sd)
            A = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2)) + 1e-9 * eye6
            dx = torch.linalg.solve(A, b)
            T_new = (se3_exp(dx.to(dtype)) @ T).to(dtype)
            c0, c1 = cost(T, inl, robust), cost(T_new, inl, robust)
            accept = (c1 < c0) & torch.isfinite(c1) & torch.isfinite(dx).all(-1)
            T = torch.where(accept[:, None, None], T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
        chi2, z = pose_chi2(T, X, uv, w_s, K, ur, bf)
        inl = valid & (chi2 <= th) & (z > 0)
    return orthonormalize(T), inl


def pose_cost_excess(T_prog, T_ref, inl_ref, X, uv, inv_sigma2, K, ur=None, bf=0.0):
    """(B,) how much more the last round's objective (chi2 summed over the
    reference's inliers) reads at the program's pose than at the reference's,
    as a share of the latter; float64; inf where the program's is not
    finite."""
    args = [v.to(F64) for v in (X, uv, inv_sigma2, K)]
    urd = None if ur is None else ur.to(F64)
    c = []
    for T in (T_prog, T_ref):
        chi2, z = pose_chi2(T.to(F64), *args[:3], args[3], urd, float(bf))
        c.append(torch.where(inl_ref & (z > 0), chi2, torch.zeros_like(chi2)).sum(-1))
    e = (c[0] - c[1]) / c[1].clamp(min=1e-9)
    return torch.where(torch.isfinite(c[0]), e, torch.inf)


# --- local BA ----------------------------------------------------------------------

def _ba_project(poses, pts, p, dtype):
    """Per observation: R (P,O,3,3), camera-frame coordinates, residuals."""
    T = poses[p["obs_cam"].clamp(min=0).long()]
    R, t = T[..., :3, :3], T[..., :3, 3]
    Xc = (R @ pts[:, None, :, None])[..., 0] + t
    x, y, z = Xc.unbind(-1)
    iz = 1.0 / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    K = p["K"]
    ru = K[0, 0] * x * iz + K[0, 2] - p["obs_uv"][..., 0]
    rv = K[1, 1] * y * iz + K[1, 2] - p["obs_uv"][..., 1]
    rur = None
    if p.get("obs_ur") is not None:
        rur = torch.where(p["obs_has_ur"], K[0, 0] * x * iz + K[0, 2] - p["bf"] * iz - p["obs_ur"],
                          torch.zeros_like(x))
    return R, x, y, z, iz, ru, rv, rur


def ba_chi2(poses, pts, p, dtype=F64):
    _, _, _, z, _, ru, rv, rur = _ba_project(poses, pts, p, dtype)
    r2 = ru * ru + rv * rv
    if rur is not None:
        r2 = r2 + rur * rur
    return r2 * p["obs_inv_sigma2"], z


def _ba_th(p, dtype):
    if p.get("obs_has_ur") is None:
        return torch.full_like(p["obs_inv_sigma2"], CHI2_MONO)
    return torch.where(p["obs_has_ur"], CHI2_STEREO, CHI2_MONO).to(dtype)


def _prep_ba(prob: dict, dtype):
    dev = prob["points"].device
    p = {}
    for k, v in prob.items():
        if isinstance(v, torch.Tensor):
            p[k] = v.to(dtype) if v.is_floating_point() else v
        else:
            p[k] = v
    if p.get("bf") is not None and not isinstance(p["bf"], torch.Tensor):
        p["bf"] = torch.tensor(float(p["bf"]), dtype=dtype, device=dev)
    return p


def solve_ba(prob: dict, iters1=5, iters2=10, lambda_init=1e-4, dtype=F64):
    """Two-phase LM on the dense damped normal equations of the free cameras
    and points; returns (cam_pose, points, inlier (P,O)) in float64."""
    p = _prep_ba(prob, dtype)
    dev = p["points"].device
    sd = _solve_dtype(dtype)
    obs_cam = p["obs_cam"]
    C, (P, O) = p["cam_pose"].shape[0], obs_cam.shape
    base = (p["obs_valid"] & (obs_cam >= 0) & p["point_valid"][:, None]
            & p["cam_valid"][obs_cam.clamp(min=0).long()])
    cam_free = p["cam_valid"] & ~p["cam_fixed"]
    pt_free = p["point_valid"] & (base.sum(1) > 0)
    # the dense unknowns: 6 per free camera, then 3 per free point
    cam_col = torch.full((C,), -1, dtype=torch.long, device=dev)
    cam_col[cam_free] = torch.arange(int(cam_free.sum()), device=dev) * 6
    n_cam = int(cam_free.sum()) * 6
    pt_col = torch.full((P,), -1, dtype=torch.long, device=dev)
    pt_col[pt_free] = n_cam + torch.arange(int(pt_free.sum()), device=dev) * 3
    n = n_cam + int(pt_free.sum()) * 3
    th = _ba_th(p, dtype)
    ccol = cam_col[obs_cam.clamp(min=0).long()]                          # (P, O)
    pcol = pt_col[:, None].expand(P, O)
    idx = torch.cat([ccol[..., None] + torch.arange(6, device=dev),
                     pcol[..., None] + torch.arange(3, device=dev)], -1)   # (P, O, 9)
    use = torch.cat([(ccol >= 0)[..., None].expand(P, O, 6), (pcol >= 0)[..., None].expand(P, O, 3)], -1)
    idx = torch.where(use, idx, n)                                        # n: dropped

    def cost(poses, pts, active, robust):
        chi2, z = ba_chi2(poses, pts, p, dtype)
        rho = chi2
        if robust:
            rho = torch.where(chi2 <= th, chi2, 2 * torch.sqrt(th * chi2.clamp(min=1e-12)) - th)
        return torch.where(active & (z > 0), rho, torch.zeros_like(rho)).sum(), chi2, z

    def step(poses, pts, active, robust, lam):
        c0, chi2, _ = cost(poses, pts, active, robust)
        wr = torch.ones_like(chi2)
        if robust:
            wr = torch.where(chi2 <= th, wr, torch.sqrt(th / chi2.clamp(min=1e-12)))
        R, x, y, z, iz, ru, rv, rur = _ba_project(poses, pts, p, dtype)
        w = torch.where(active & (z > 0), p["obs_inv_sigma2"] * wr, torch.zeros_like(wr))
        K = p["K"]
        fx, fy = K[0, 0], K[1, 1]
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        Ju = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2, fx * (1 + x * x * iz2),
                          -fx * y * iz], -1)
        Jv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1 + y * y * iz2), fy * x * y * iz2,
                          fy * x * iz], -1)
        du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
        dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
        Jpu = (du[..., None, :] @ R)[..., 0, :]
        Jpv = (dv[..., None, :] @ R)[..., 0, :]
        rows = [(torch.cat([Ju, Jpu], -1), ru, w), (torch.cat([Jv, Jpv], -1), rv, w)]
        if rur is not None:
            g = p["bf"] * iz2
            Jur = Ju + g[..., None] * torch.stack([zero, zero, torch.ones_like(x), y, -x, zero], -1)
            Jpur = Jpu + g[..., None] * R[..., 2, :]
            rows.append((torch.cat([Jur, Jpur], -1), rur, w * p["obs_has_ur"]))
        blk = sum(J[..., :, None] * J[..., None, :] * ww[..., None, None] for J, _, ww in rows)
        rhs = sum(J * (r * ww)[..., None] for J, r, ww in rows)
        fin = torch.isfinite(blk).all(-1).all(-1) & torch.isfinite(rhs).all(-1)
        blk = torch.where(fin[..., None, None], blk, torch.zeros_like(blk)).to(sd)
        rhs = torch.where(fin[..., None], rhs, torch.zeros_like(rhs)).to(sd)
        H = torch.zeros((n + 1) * (n + 1), dtype=sd, device=dev)
        lin = (idx[..., :, None] * (n + 1) + idx[..., None, :]).reshape(-1)
        H.index_put_((lin,), blk.reshape(-1), accumulate=True)
        H = H.reshape(n + 1, n + 1)[:n, :n]
        bvec = torch.zeros(n + 1, dtype=sd, device=dev)
        bvec.index_put_((idx.reshape(-1),), -rhs.reshape(-1), accumulate=True)
        bvec = bvec[:n]
        d = torch.diagonal(H)
        H = H + torch.diag(lam * d.clamp(min=1e-6))
        H[:n_cam, :n_cam] += 1e-8 * torch.eye(n_cam, dtype=sd, device=dev)
        # a system that is not positive definite gives NaN and is rejected
        L, info = torch.linalg.cholesky_ex(H)
        dxx = torch.where(info == 0, torch.cholesky_solve(bvec[:, None], L)[:, 0], torch.nan)
        dc = torch.zeros((C, 6), dtype=dtype, device=dev)
        dc[cam_free] = dxx[:n_cam].reshape(-1, 6).to(dtype)
        dp = torch.zeros((P, 3), dtype=dtype, device=dev)
        dp[pt_free] = dxx[n_cam:].reshape(-1, 3).to(dtype)
        new_poses = torch.where(cam_free[:, None, None], (se3_exp(dc) @ poses).to(dtype), poses)
        new_pts = pts + dp
        c1, _, _ = cost(new_poses, new_pts, active, robust)
        accept = (c1 < c0) & torch.isfinite(c1) & torch.isfinite(dxx).all()
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0), 1e-5, 1e3)
        return (torch.where(accept, new_poses, poses), torch.where(accept, new_pts, pts), lam)

    poses, pts = p["cam_pose"], p["points"]
    lam = torch.tensor(lambda_init, dtype=sd, device=dev)
    for _ in range(iters1):
        poses, pts, lam = step(poses, pts, base, True, lam)
    chi2, z = ba_chi2(poses, pts, p, dtype)
    inlier = base & (chi2 <= th) & (z > 0)
    lam = torch.tensor(lambda_init, dtype=sd, device=dev)
    for _ in range(iters2):
        poses, pts, lam = step(poses, pts, inlier, False, lam)
    return orthonormalize(poses), pts.to(F64), inlier


def ba_final_inlier(poses, pts, prob: dict) -> torch.Tensor:
    """(P, O) observations a BA's final state holds as inliers: chi2 under
    the threshold in front of the camera (the program's ``ba_finalize``
    rule), float64."""
    p = _prep_ba(prob, F64)
    base = (p["obs_valid"] & (p["obs_cam"] >= 0) & p["point_valid"][:, None]
            & p["cam_valid"][p["obs_cam"].clamp(min=0).long()])
    chi2, z = ba_chi2(poses.to(F64), pts.to(F64), p)
    return base & (chi2 <= _ba_th(p, F64)) & (z > 0)


def ba_compare(prog_poses, prog_pts, prog_inlier, ref_poses, ref_pts, inlier_ref,
               prob: dict) -> tuple[float, float]:
    """(cost excess, inlier difference) of a BA's result against the
    reference's, float64.

    The inlier difference is the share of the problem's observations that
    the two final states classify differently. The cost excess is how much
    more the refinement's objective (chi2 over the reference's inlier
    observations) reads at the program's cameras and points than at the
    reference's, as a share of the latter, over the points whose
    observations both final states classify alike: a point with an
    observation at the threshold is refined over another set of
    observations on each side and takes another position (PERF.md)."""
    p = _prep_ba(prob, F64)
    base = (p["obs_valid"] & (p["obs_cam"] >= 0) & p["point_valid"][:, None]
            & p["cam_valid"][p["obs_cam"].clamp(min=0).long()])
    differ = (prog_inlier.to(base.device) != ba_final_inlier(ref_poses, ref_pts, prob)) & base
    share = float(differ.sum()) / max(int(base.sum()), 1)
    keep = inlier_ref & ~differ.any(1, keepdim=True)
    c = []
    for poses, pts in ((prog_poses, prog_pts), (ref_poses, ref_pts)):
        chi2, z = ba_chi2(poses.to(F64), pts.to(F64), p)
        c.append(torch.where(keep & (z > 0), chi2, torch.zeros_like(chi2)).sum())
    if not torch.isfinite(c[0]):
        return float("inf"), share
    return float((c[0] - c[1]) / c[1].clamp(min=1e-9)), share


# --- relocalization's PnP --------------------------------------------------------------

def pnp_draws(seed: int, frame_id: int, kf_id: int, n_valid: int, n_iters=300, sample=6):
    """The program's RANSAC draws, from its stated seed rule (cfg.seed + 31 x
    frame + keyframe): (n_iters, sample) int64 indices into the valid rows."""
    g = torch.Generator().manual_seed(seed + 31 * frame_id + kf_id)
    return torch.randint(0, max(int(n_valid), 1), (n_iters, sample), generator=g)


def _dlt(Xw, xn, sd):
    B, S = Xw.shape[:2]
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], -1)
    zeros = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], -1),
                   torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)], -2)
    _, _, vt = torch.linalg.svd(A.to(sd))
    Pm = vt[:, -1].reshape(B, 3, 4)
    U, Sv, Vt = torch.linalg.svd(Pm[..., :3])
    R = U @ Vt
    neg = torch.linalg.det(R) < 0
    R = torch.where(neg[:, None, None], -R, R)
    scale = Sv.mean(-1) * torch.where(neg, -1.0, 1.0).to(sd)
    t = Pm[..., 3] / torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)[:, None]
    T = torch.zeros((B, 4, 4), dtype=sd, device=Xw.device)
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, t, 1
    return T


def pnp_inliers(T, X, uv, valid, inv_sigma2, K, chi2_th=CHI2_MONO):
    """(…, N) inlier masks of poses T (…, 4, 4) under the RANSAC gate."""
    Pc = (T[..., None, :3, :3] @ X[..., :, :, None])[..., 0] + T[..., None, :3, 3]
    z = Pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * Pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / zs + K[1, 2]
    chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    return valid & (z > 0) & (chi2 < chi2_th)


def ransac_pnp(X, uv, valid, inv_sigma2, K, draws, dtype=F64):
    """(best pose float64, its inlier count) over the draws' hypotheses."""
    dev = X.device
    X, uv, w, K = (v.to(device=dev, dtype=dtype) for v in (X, uv, inv_sigma2, K))
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    sample_idx = order[draws.to(dev).long()]
    uvh = torch.cat([uv, torch.ones_like(uv[:, :1])], 1)
    xn = (uvh.to(F64) @ torch.linalg.inv(K.to(F64)).T)[:, :2].to(dtype)
    Ts = _dlt(X[sample_idx], xn[sample_idx], _solve_dtype(dtype)).to(dtype)
    inls = pnp_inliers(Ts, X, uv, valid, w, K)
    counts = inls.sum(1)
    counts = torch.where(torch.isfinite(Ts.reshape(Ts.shape[0], -1)).all(1), counts, -1)
    best = int(torch.argmax(counts))
    return Ts[best].to(F64), int(counts[best].clamp(min=0))


def pnp_deficit(T_prog, n_ref: int, X, uv, valid, inv_sigma2, K) -> float:
    """The share of the reference's best inlier count that the program's
    pose falls short of, its inliers counted in float64."""
    if n_ref <= 0:
        return 0.0
    n_prog = int(pnp_inliers(T_prog.to(F64), X.to(F64), uv.to(F64), valid, inv_sigma2.to(F64),
                             K.to(F64)).sum())
    return (n_ref - n_prog) / n_ref


# --- kernel B --------------------------------------------------------------------------

def windowed_best2(args, chi2_th: float, dtype=torch.float32):
    """Kernel B's plain form; the control rounds the positions, windows and
    weights to bfloat16 first."""
    args = list(args)
    if dtype == torch.bfloat16:
        for i in (4, 5, 6, 10):
            args[i] = args[i].to(torch.bfloat16).to(torch.float32)
    return windowed_best2_plain(*args, chi2_th)


# --- stereo and depth ------------------------------------------------------------------

TH_HIGH = 100  # ORBmatcher::TH_HIGH, the descriptor gate of Frame.cc:637
SAD_W = 5      # the 11x11 block's half width (Frame.cc:684)
SAD_L = 5      # the slide, +-L px (Frame.cc:690)


def stereo_match(left, right, left_img, right_img, bf: float, min_z: float, scales,
                 n_levels: int, dtype=torch.float32):
    """Frame::ComputeStereoMatches under the port's gates, each left
    keypoint on its own (a row of the arrays below). For left keypoint i:
    the right keypoints j whose row lies within 2 x the scale of j's octave
    of i's, whose disparity x_i - x_j lies in [-3, bf / min_z] and whose
    octave is within one of i's are the candidates; the one of least
    Hamming distance (the first on a tie) is matched if that distance is
    under TH_HIGH. Then the 11x11 block around i, less its centre, is
    compared by the sum of absolute differences with the right image's block
    at x_j + o for o in -5..5, less its centre (blocks clamped to the
    image); the parabola through the best offset (held one step inside the
    slide) and its neighbours, its step clamped to +-1 px, gives u_right,
    kept where the disparity x_i - u_right lies in (0, bf / min_z).
    Returns (depth, u_right, matched right index), -1 where no match is
    kept.

    ``dtype=torch.bfloat16`` is the control: positions, scales, images and
    block sums in bfloat16."""
    dev = left_img.device
    q = lambda v: v.to(device=dev, dtype=dtype)  # noqa: E731
    xl, yl = q(left.xy[:, 0]), q(left.xy[:, 1])
    xr, yr = q(right.xy[:, 0]), q(right.xy[:, 1])
    img_l, img_r = q(left_img), q(right_img)
    bf_t, min_z_t = (torch.tensor(v, dtype=torch.float32, device=dev).to(dtype)
                     for v in (bf, min_z))
    max_d = bf_t / torch.clamp(min_z_t, min=1e-6)
    oct_l, oct_r = left.octave.to(dev).long(), right.octave.to(dev).long()
    H, W = img_l.shape
    # candidates: rows i (left) x columns j (right)
    band = 2.0 * q(scales)[oct_r.clamp(0, n_levels - 1)]
    disp = xl[:, None] - xr[None, :]
    cand = (left.valid.to(dev)[:, None] & right.valid.to(dev)[None, :]
            & ((yl[:, None] - yr[None, :]).abs() <= band[None, :])
            & (disp >= -3.0) & (disp <= max_d) & ((oct_l[:, None] - oct_r[None, :]).abs() <= 1))
    dist = hamming.distance_matrix(left.desc.to(dev), right.desc.to(dev)).long()
    dist = torch.where(cand, dist, 1 << 20)
    j = torch.argmin(dist, 1)                          # the first of the least
    matched = dist.gather(1, j[:, None])[:, 0] < TH_HIGH
    # the SAD slide, keypoint by keypoint along the rows
    offs = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    rows = (torch.round(yl).long()[:, None] + offs).clamp(0, H - 1)           # (N, 11)
    cols = (torch.round(xl).long()[:, None] + offs).clamp(0, W - 1)
    block_l = img_l[rows[:, :, None], cols[:, None, :]]                       # (N, 11, 11)
    block_l = block_l - block_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    x0 = xr[j]
    sads = []
    for o in range(-SAD_L, SAD_L + 1):
        cols_r = (torch.round(x0).long()[:, None] + o + offs).clamp(0, W - 1)
        block_r = img_r[rows[:, :, None], cols_r[:, None, :]]
        block_r = block_r - block_r[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
        sads.append((block_l - block_r).abs().sum((1, 2)))
    sads = torch.stack(sads, 1)                                               # (N, 11)
    c = torch.argmin(sads, 1).clamp(1, 2 * SAD_L - 1)
    s_m, s_0, s_p = (sads.gather(1, (c + k)[:, None])[:, 0] for k in (-1, 0, 1))
    denom = torch.clamp(s_m + s_p - 2.0 * s_0, min=1e-6)
    delta = (0.5 * (s_m - s_p) / denom).clamp(-1.0, 1.0)
    u = x0 + (c.to(dtype) - SAD_L) + delta
    disparity = xl - u
    keep = matched & (disparity > 0.0) & (disparity < max_d)
    depth = torch.where(keep, bf_t / torch.clamp(disparity, min=1e-3), -1.0).float()
    return depth, torch.where(keep, u, -1.0).float(), torch.where(keep, j, -1)


def stereo_compare(prog_depth, prog_ur, ref_depth, ref_ur) -> tuple[int, float]:
    """(left keypoints whose match differs, the largest |u_right - the
    reference's| px over those matched in both). A keypoint's match
    differs where one side keeps a match and the other not, or where both
    keep one and their u_right lie half a pixel or more apart: another
    right keypoint or another SAD offset, which no rounding gives."""
    got = prog_depth.to(ref_depth.device) >= 0
    ref = ref_depth >= 0
    both = got & ref
    err = torch.where(both, (prog_ur.to(ref_ur.device).float() - ref_ur).abs(),
                      torch.zeros_like(ref_ur))
    differ = (got != ref) | (both & (err >= 0.5))
    return int(differ.sum()), float(err.max()) if err.numel() else 0.0


def depth_lookup(feats, depth_map: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Frame::ComputeStereoFromRGBD: each valid keypoint's depth is the
    depth image's pixel nearest to it (rounded half to even, held inside the
    image), -1 where the keypoint is invalid or the pixel holds no depth.
    ``dtype=torch.bfloat16`` is the control: the depth image in bfloat16."""
    dmap = depth_map.to(dtype).to(torch.float32)
    H, W = dmap.shape
    xy = feats.xy.to(dmap.device)
    d = dmap[torch.round(xy[:, 1]).long().clamp(0, H - 1), torch.round(xy[:, 0]).long().clamp(0, W - 1)]
    return torch.where(feats.valid.to(dmap.device) & (d > 0), d, -1.0)
