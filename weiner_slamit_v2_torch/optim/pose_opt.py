"""Motion-only pose optimization: Levenberg-Marquardt on SE(3) (port of
weiner_slamit_v2_tpu/optim/pose_opt.py; Optimizer::PoseOptimization,
src/Optimizer.cc:239-451): 4 rounds x 10 LM iterations, Huber in rounds 0-1,
chi2 reclassification between rounds. Features with a stereo right-u
(ur >= 0) add the third row u - bf/z - ur (EdgeStereoSE3ProjectXYZOnlyPose,
Optimizer.cc:274-310) with the 3-dof gate 7.815 as chi2 threshold and Huber
delta^2; without ``ur`` the computation is the monocular one, unchanged."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..ops import xla_math
from ..util import fma

CHI2_MONO = 5.991
CHI2_STEREO = 7.815     # 3-dof 95% gate (Optimizer.cc:310)
HUBER_MONO = 2.4476519  # sqrt(5.991), Optimizer.cc:287


_F32_1E_20 = float(np.float32(1e-20))


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the damped 6x6 normal system A x = b as the JAX package's
    ``solve6`` does: an unrolled Cholesky with every pivot clamped at
    ``sqrt(max(s, 1e-20))``, forward and back substitution, in the JAX
    package's operation order. A is read below its diagonal only. XLA:CPU
    fuses each ``s - L[i][k] * L[j][k]`` into one fused multiply-add; here
    that is a float64 ``addr`` / ``addcmul`` of float32 values rounded once
    to float32 (``util.fma``), and the root is ``xla_math.sqrt`` (torch's CPU
    float32 root is not correctly rounded; its division is). The
    factorization and the forward substitution update whole columns a step
    (every entry still subtracts its terms in the order k = 0, 1, ...); the
    back substitution subtracts in ascending k too, so it is a chain of
    single fused multiply-adds. No library solver: a matrix that is not
    positive definite after rounding gives a finite clamped step, as in
    JAX, and the card computes what the CPU does."""
    d, f = torch.float64, torch.float32
    S, y = A, b
    diag, cols, ys = [], [], []
    for k in range(6):
        m = torch.clamp(S[0, 0], min=_F32_1E_20)
        dk = xla_math.sqrt(m)
        col = S[1:, 0] / dk
        diag.append(dk)
        cols.append(col)
        if k == 5:
            break
        yk = y[0] / dk
        ys.append(yk)
        S = torch.addr(S[1:, 1:].to(d), col, col, alpha=-1.0).to(f)
        y = fma(col, yk, y[1:], value=-1.0)
    # x5 = y5 / L55 = (s / sqrt(m)) / sqrt(m): XLA's simplifier folds it to s / m
    x = [None] * 5 + [y[0] / m]
    for i in reversed(range(5)):
        s = ys[i]
        for k in range(i + 1, 6):
            s = fma(cols[i][k - i - 1], x[k], s, value=-1.0)
        x[i] = s / diag[i]
    return torch.stack(x)


def _residuals_jacobian(Tcw, X, uv, fx, fy, cx, cy, ur=None, bf=0.0):
    """(ru, rv, Ju (6,N), Jv (6,N), z): residuals and Jacobian rows of the
    left-multiplicative tangent [upsilon, omega]; with ``ur`` also the stereo
    row (rur, Jur): u_r = u - bf/z, so d(u_r) = du + bf/z^2 dz with
    dz = [0, 0, 1, y, -x, 0]."""
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
    if ur is None:
        return ru, rv, Ju, Jv, z
    rur = (fx * x * iz + cx) - bf * iz - ur
    Jz = torch.stack([zero, zero, torch.ones_like(x), y, -x, zero])
    return ru, rv, Ju, Jv, z, rur, Ju + (bf * iz2) * Jz


def _lm_tail(H, b, lam, Tcw):
    """(dx, updated pose) of one LM iteration: the damping (XLA fuses
    ``lam * diag(H) + H`` into one multiply-add), the solve, the update."""
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    dx = solve6(fma(lam, torch.diag(torch.diag(H)), H) + 1e-9 * eye6, b)
    return dx, se3.retract(Tcw, dx)


# On the card the tail replays as one CUDA graph per device: its exact forms
# are ~300 launches on 0-d and 6x6 tensors, which the host would enqueue one
# by one; the graph runs the same kernels on the same inputs, so the bits are
# the eager tail's. A Tracker captures it when it is built (capture_tail),
# outside any step: a capture synchronizes the device. A graph being captured
# cannot replay this one, so optimize_pose on the card cannot itself be
# captured into a CUDA graph.
_TAIL_GRAPHS: dict = {}


def capture_tail(dev) -> None:
    """Capture _lm_tail's CUDA graph on the card ``dev`` once (later calls
    return at once). The capture synchronizes the device, so call it outside
    any step or batch: Tracker.__init__ does."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev in _TAIL_GRAPHS:
        return
    with torch.cuda.device(dev):
        ins = (torch.eye(6, device=dev), torch.zeros(6, device=dev),
               torch.full((), 1e-3, device=dev), torch.eye(4, device=dev))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):          # warm up: device constants, allocator
            _lm_tail(*ins)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = _lm_tail(*ins)
    _TAIL_GRAPHS[dev] = (graph, ins, outs)


def _damped_step(H, b, lam, Tcw):
    """_lm_tail; on the card a replay of the device's graph (capture_tail),
    whose outputs are its buffers: read them before the next call."""
    if not H.is_cuda:
        return _lm_tail(H, b, lam, Tcw)
    if H.device not in _TAIL_GRAPHS:
        raise RuntimeError(f"the pose LM's graph on {H.device} is not captured: call "
                           f"pose_opt.capture_tail(device) outside any step (a Tracker does)")
    graph, ins, outs = _TAIL_GRAPHS[H.device]
    for dst, src in zip(ins, (H, b, lam, Tcw)):
        dst.copy_(src)
    graph.replay()
    return outs


def optimize_pose(Tcw0, X, uv, inv_sigma2, valid, K, n_rounds: int = 4,
                  n_iters: int = 10, chi2_th: float = CHI2_MONO,
                  lambda_init: float = 1e-3, ur=None, bf=0.0):
    """Optimize one pose against fixed points X (N,3) observed at uv (N,2).
    ur: (N,) the frame's stereo right-u per feature, -1 for a monocular one
    (mvuRight); bf: baseline x fx. Returns (Tcw (4,4), inliers (N,) bool,
    n_inliers ())."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stereo = ur is not None
    if stereo:
        is_st = ur >= 0
        delta2 = torch.where(is_st, CHI2_STEREO, CHI2_MONO)   # Huber delta^2 per feature
        chi2_th = torch.where(is_st, CHI2_STEREO, chi2_th)
    else:
        delta2 = CHI2_MONO

    def resid(Tcw):
        out = _residuals_jacobian(Tcw, X, uv, fx, fy, cx, cy, ur, bf)
        if not stereo:
            return (*out, None, None)
        ru, rv, Ju, Jv, z, rur, Jur = out
        return ru, rv, Ju, Jv, z, torch.where(is_st, rur, 0.0), Jur

    def chi2_of(Tcw):
        ru, rv, _, _, z, rur, _ = resid(Tcw)
        c = ru * ru + rv * rv
        if stereo:
            c = c + rur * rur
        return c * inv_sigma2, z

    def robust_cost(chi2, z, mask, robust):
        rho = chi2
        if robust:
            rho = torch.where(chi2 <= delta2, chi2,
                              2.0 * xla_math.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
        return torch.where(mask & (z > 0), rho, 0.0).sum()

    Tcw, inliers = Tcw0, valid
    for rnd in range(n_rounds):
        robust = rnd < 2   # robust kernel off from round 2 (Optimizer.cc:432)
        lam = torch.full((), lambda_init, dtype=torch.float32, device=Tcw0.device)
        for _ in range(n_iters):
            ru, rv, Ju, Jv, z, rur, Jur = resid(Tcw)
            chi2 = (ru * ru + rv * rv) * inv_sigma2
            if stereo:
                chi2 = chi2 + rur * rur * inv_sigma2
            # the roots correctly rounded, as XLA's (torch's CPU float32 root is not)
            wr = torch.where(chi2 <= delta2, 1.0, xla_math.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
            w = inv_sigma2 * (wr if robust else 1.0)
            w = torch.where(inliers & (z > 0), w, 0.0)
            Juw, Jvw = Ju * w, Jv * w
            H = Juw @ Ju.T + Jvw @ Jv.T
            b = -(Juw @ ru + Jvw @ rv)
            if stereo:
                Jurw = Jur * (w * is_st)
                H = H + Jurw @ Jur.T
                b = b - Jurw @ rur
            cost0 = robust_cost(chi2, z, inliers, robust)
            dx, T_new = _damped_step(H, b, lam, Tcw)
            c_new, z_new = chi2_of(T_new)
            cost1 = robust_cost(c_new, z_new, inliers, robust)
            accept = (cost1 < cost0) & torch.isfinite(cost1) & torch.isfinite(dx).all()
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
        chi2, z = chi2_of(Tcw)
        inliers = valid & (chi2 <= chi2_th) & (z > 0)
    return se3.orthonormalize(Tcw), inliers, inliers.sum()
