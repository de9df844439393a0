"""Sim3 geometry and the Sim3 solver, the port against the JAX package on the
same seeded numpy inputs: the new se3 functions and sim3 exp / log / inv /
to_se3 (float32, atol 1e-5, small angles and small log-scales included),
Horn's closed form, RANSAC with the JAX draws fed (inlier mask and count
exact, S12 within 1e-4), the GN refinement, and fix_scale (scale exactly 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry import sim3 as jsim3
from weiner_slamit_v2_tpu.optim import sim3_solver as jsolver
from weiner_slamit_v2_torch.geometry import se3, sim3
from weiner_slamit_v2_torch.optim import sim3_solver

torch.set_num_threads(1)
ATOL = 1e-5


def t_(a):
    return torch.from_numpy(np.array(a))


def tangents(rng, n, dim):
    """Random tangents at three magnitudes: ordinary, small (series branches)
    and zero."""
    x = rng.normal(0, 0.4, (n, dim)).astype(np.float32)
    x[n // 3: 2 * n // 3] *= 1e-6
    x[2 * n // 3:] = 0.0
    return x


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def test_so3_and_se3_log_match_jax():
    rng = np.random.default_rng(0)
    w = tangents(rng, 30, 3)
    close(se3.so3_exp(t_(w)), jse3.so3_exp(jnp.asarray(w)))
    close(se3._left_jacobian(t_(w)), jse3._left_jacobian(jnp.asarray(w)))
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    close(se3.so3_log(t_(R)), jse3.so3_log(jnp.asarray(R)))
    xi = tangents(rng, 30, 6)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    close(se3.log(t_(T)), jse3.log(jnp.asarray(T)))
    q = rng.normal(size=(20, 4)).astype(np.float32)
    close(se3.rot_from_quat(t_(q)), jse3.rot_from_quat(jnp.asarray(q)))


def test_sim3_exp_log_inv_to_se3_match_jax():
    rng = np.random.default_rng(1)
    xi = tangents(rng, 60, 7)
    # small sigma with a large rotation and the reverse: the mixed branches
    xi[3:8, 6] = rng.normal(0, 1e-7, 5)
    xi[40:45, 6] = rng.normal(0, 0.3, 5)
    S = np.asarray(jsim3.exp(jnp.asarray(xi)))
    close(sim3.exp(t_(xi)), S)
    close(sim3.log(t_(S)), jsim3.log(jnp.asarray(S)))
    close(sim3.inv(t_(S)), jsim3.inv(jnp.asarray(S)))
    close(sim3.to_se3(t_(S)), jsim3.to_se3(jnp.asarray(S)))
    close(sim3.scale_of(t_(S)), jsim3.scale_of(jnp.asarray(S)))
    w, sig = xi[:, 3:6], xi[:, 6]
    close(sim3._W(t_(w), t_(sig), torch.exp(t_(sig))),
          jsim3._W(jnp.asarray(w), jnp.asarray(sig), jnp.exp(jnp.asarray(sig))))


def test_sim3_jacobian_is_finite_at_identity():
    """Forward-mode derivatives of log(exp(xi) S) at xi = 0 stay finite: the
    unselected branches of _W's wheres have safe denominators."""
    S = sim3.exp(torch.zeros(1, 7))
    J = torch.func.jacfwd(lambda x: sim3.log(sim3.exp(x) @ S))(torch.zeros(1, 7))
    assert torch.isfinite(J).all()
    close(J[0, :, 0], np.eye(7), atol=1e-5)


def sim3_scene(seed, n=80, n_out=20, scale=1.3):
    """Points seen by two cameras related by a Sim3 (X1 = s R X2 + t), the
    keypoints with 0.5 px noise, the last n_out matches wrong."""
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(3, 6, n)], 1)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.08, 0.03], jnp.float32)))
    t = np.array([0.2, -0.05, 0.1])
    X2 = ((X1 - t) @ R) / scale
    X2[n - n_out:] = X2[rng.permutation(n_out) + n - n_out] + rng.normal(0, 0.3, (n_out, 3))
    Kn = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)

    def proj(X):
        return np.stack([300 * X[:, 0] / X[:, 2] + 160, 300 * X[:, 1] / X[:, 2] + 120], 1)

    uv1 = proj(X1) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(X2) + rng.normal(0, 0.5, (n, 2))
    valid = rng.uniform(size=n) > 0.1
    w = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return [a.astype(np.float32) if a.dtype.kind == "f" else a
            for a in (X1, X2, valid, uv1, uv2, w, w[::-1].copy(), Kn)]


def test_horn_sim3_matches_jax():
    rng = np.random.default_rng(2)
    P2 = rng.normal(size=(10, 3, 3)).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.5, (10, 3)), jnp.float32)))
    P1 = (1.7 * np.einsum("bij,bnj->bni", R, P2) + rng.normal(size=(10, 1, 3))).astype(np.float32)
    for fix in (False, True):
        got = sim3_solver.horn_sim3(t_(P1), t_(P2), fix)
        want = jax.vmap(lambda a, b: jsolver.horn_sim3(a, b, fix))(jnp.asarray(P1), jnp.asarray(P2))
        close(got, want, atol=1e-4)
        if fix:   # s = 1: the scale read back is the rotation row's norm
            close(sim3.scale_of(got), np.ones(10), atol=1e-6)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_and_refine_sim3_match_jax(fix_scale):
    X1, X2, valid, uv1, uv2, w1, w2, Kn = sim3_scene(3, scale=1.0 if fix_scale else 1.3)
    key = jax.random.PRNGKey(11)
    j = [jnp.asarray(a) for a in (X1, X2, valid, uv1, uv2, w1, w2, Kn)]
    S_j, inl_j, n_j = jsolver.ransac_sim3(*j, key, fix_scale=fix_scale)
    draws = np.asarray(jax.random.randint(key, (jsolver.N_ITERS, jsolver.SAMPLE), 0,
                                          max(int(valid.sum()), 1)))
    tt = [t_(a) for a in (X1, X2, valid, uv1, uv2, w1, w2, Kn)]
    S_t, inl_t, n_t = sim3_solver.ransac_sim3(*tt, t_(draws), fix_scale=fix_scale)
    assert int(n_t) == int(n_j) > 40
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    close(S_t, S_j, atol=1e-4)

    # the refinement's first steps weigh every valid match without a robust
    # kernel: give it the inliers and 4 of the wrong matches (both packages
    # diverge alike on 20 of them)
    keep = np.asarray(inl_j).copy()
    keep[60:64] = True
    j[2], tt[2] = jnp.asarray(keep), t_(keep)
    R_j, rinl_j, rn_j = jsolver.refine_sim3(S_j, *j, fix_scale=fix_scale)
    R_t, rinl_t, rn_t = sim3_solver.refine_sim3(t_(np.asarray(S_j)), *tt, fix_scale=fix_scale)
    assert int(rn_t) < int(keep.sum())
    assert int(rn_t) == int(rn_j)
    np.testing.assert_array_equal(rinl_t.numpy(), np.asarray(rinl_j))
    close(R_t, R_j, atol=1e-4)
    if fix_scale:
        close(sim3.scale_of(torch.stack([S_t, R_t])), np.ones(2), atol=1e-6)


def test_fix_scale_ransac_on_scaled_data():
    """tests/test_loop.py::test_loop_closer_fixes_scale_for_rgbd: a fixed-
    scale RANSAC on data scaled by 1.25 returns scale 1, as in JAX."""
    rng = np.random.default_rng(0)
    X1 = (rng.uniform(-1, 1, (60, 3)) + [0, 0, 5]).astype(np.float32)
    R = np.asarray([[0.9950042, -0.0998334, 0], [0.0998334, 0.9950042, 0], [0, 0, 1]], np.float32)
    X2 = (1.25 * (X1 @ R.T) + np.asarray([0.2, -0.1, 0.3], np.float32)).astype(np.float32)
    Kn = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    uv1 = np.stack([500 * X1[:, 0] / X1[:, 2] + 320, 500 * X1[:, 1] / X1[:, 2] + 240], 1)
    uv2 = np.stack([500 * X2[:, 0] / X2[:, 2] + 320, 500 * X2[:, 1] / X2[:, 2] + 240], 1)
    args = (X2, X1, np.ones(60, bool), uv2.astype(np.float32), uv1.astype(np.float32),
            np.ones(60, np.float32), np.ones(60, np.float32), Kn)
    key = jax.random.PRNGKey(0)
    S_j, _, n_j = jsolver.ransac_sim3(*map(jnp.asarray, args), key, fix_scale=True)
    draws = np.asarray(jax.random.randint(key, (300, 3), 0, 60))
    S_t, _, n_t = sim3_solver.ransac_sim3(*map(t_, args), t_(draws), fix_scale=True)
    assert abs(float(sim3.scale_of(S_t)) - 1.0) < 1e-6 and int(n_t) == int(n_j)
    close(S_t, S_j, atol=1e-4)
