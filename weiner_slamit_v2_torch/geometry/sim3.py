"""Sim(3) similarity transforms (port of weiner_slamit_v2_tpu/geometry/sim3.py;
g2o's ``Sim3`` as the reference's loop closing uses it, src/Optimizer.cc:781-1044,
src/Sim3Solver.cc).

A Sim3 is the 4x4 matrix ``[[s R, t], [0, 1]]``; tangent vectors are
7-vectors ``[upsilon, omega, sigma]`` (translation, rotation, log-scale), g2o's
order. Every function broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def from_rts(R: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """Assemble a 4x4 Sim3 from rotation, translation and scale."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    return se3.from_rt(s[..., None, None] * R, t)


def scale_of(S: torch.Tensor) -> torch.Tensor:
    """The scale: the norm of the first row of s R."""
    return torch.linalg.norm(S[..., 0, :3], dim=-1)


def rot_of(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / scale_of(S)[..., None, None]


def trans_of(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, 3]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_se3(T: torch.Tensor) -> torch.Tensor:
    """An SE3 as a Sim3 of scale 1 (the same matrix)."""
    return T


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """[R, t / s; 0, 1], the recovery after the essential graph
    (src/Optimizer.cc:1003-1012)."""
    s = scale_of(S)
    return se3.from_rt(rot_of(S), trans_of(S) / s[..., None])


def inv(S: torch.Tensor) -> torch.Tensor:
    s = scale_of(S)
    Rt = rot_of(S).transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ trans_of(S)[..., None])[..., 0]
    return from_rts(Rt, t_inv, s_inv)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """s R X + t (batched)."""
    return (S[..., :3, :3] @ X[..., None])[..., 0] + S[..., :3, 3]


def _W(omega: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W with t = W @ upsilon in the Sim(3) exponential (Strasdat's closed
    form A I + B hat(w) + C hat(w)^2), with series limits for small theta and
    small sigma. Every denominator of an unselected branch is made safe, so
    forward-mode derivatives stay finite on both sides of each where."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = se3.hat(omega)
    K2 = K @ K
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)

    small_sig = sigma.abs() < 1e-5
    small_th = theta < 1e-4
    sig_safe = torch.where(small_sig, 1.0, sigma)
    theta_safe = torch.where(small_th, 1.0, theta)
    theta2_safe = torch.where(small_th, 1.0, theta2)

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)

    denom = sigma * sigma + theta2
    denom_safe = torch.where(denom < _EPS, 1.0, denom)
    s_cos = s * torch.cos(theta_safe)
    s_sin = s * torch.sin(theta_safe)
    B_gen = (sigma * s_sin + (1.0 - s_cos) * theta_safe) / (theta_safe * denom_safe)
    C_gen = (A - ((s_cos - 1.0) * sigma + s_sin * theta_safe) / denom_safe) / theta2_safe

    # theta -> 0 limits (exact in sigma), then their sigma -> 0 limits
    sig3_safe = sig_safe * sig_safe * sig_safe
    B_lim = torch.where(small_sig, 0.5 + sigma / 3.0, (sigma * s + 1.0 - s) / (sig_safe * sig_safe))
    C_lim = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                        (s - 1.0 - sigma * s + sigma * sigma * s / 2.0) / sig3_safe)

    B = torch.where(small_th, B_lim, B_gen)
    C = torch.where(small_th, C_lim, C_gen)
    return A[..., None, None] * eye + B[..., None, None] * K + C[..., None, None] * K2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential of [upsilon, omega, sigma] (batched)."""
    upsilon, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    W = _W(omega, sigma, s)
    return from_rts(se3.so3_exp(omega), (W @ upsilon[..., None])[..., 0], s)


def log(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm -> [upsilon, omega, sigma] (batched)."""
    s = scale_of(S)
    sigma = torch.log(s)
    omega = se3.so3_log(rot_of(S))
    W = _W(omega, sigma, s)
    upsilon = torch.linalg.solve_ex(W, trans_of(S)[..., None])[0][..., 0]   # no host check
    return torch.cat([upsilon, omega, sigma[..., None]], -1)


def retract(S: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ S (g2o's convention)."""
    return exp(xi) @ S
