"""The pose LM's own arithmetic against the JAX package's compiled programs,
bit for bit (jax/jaxlib 0.9.0, XLA:CPU with ``--xla_cpu_max_isa=AVX2``, as
tests/conftest.py runs it):

* ``solve6``: jitted JAX ``solve6`` on seeded damped normal systems (an
  upper triangle that differs from the lower one, which is never read) and
  on a system that is not positive definite after rounding (LAPACK's
  Cholesky stops at its sixth pivot; JAX clamps it and steps finitely);
* ``se3.exp``: jitted JAX ``exp`` of one 6-vector, on 100,000 seeded
  tangents, half of them under the small-angle threshold;
* inside ``optimize_pose``'s own program: a copy of its LM loop that also
  returns every iteration's state (and whose result equals the real
  program's) gives each iteration's normal matrix, damping, step and pose;
  the port's damping (one fused multiply-add), ``solve6`` and
  ``se3.retract`` on those inputs equal the program's outputs on all 40
  iterations. So the tracker's program compiles the solve as the
  standalone ``jax.jit(solve6)`` does: every ``s - L[i][k] * L[j][k]`` one
  fused multiply-add (vfnmadd in the object code) and x5 folded to
  s / max(s55, 1e-20) by XLA's simplifier.

The ``cuda`` cases hold the card's results against the CPU port's; they
import no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_pose_solve.py
"""

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch.geometry import se3
from weiner_slamit_v2_torch.optim import pose_opt
from weiner_slamit_v2_torch.util import fma

torch.set_num_threads(1)


def spd_systems(n: int = 500, seed: int = 1):
    """Damped normal systems A = M M^T + 1e-3 diag, entries across five
    decades, with an upper triangle that differs from the lower."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        M = rng.normal(size=(6, 40)).astype(np.float32) * np.float32(10 ** rng.uniform(-2, 3))
        A = (M @ M.T).astype(np.float32)
        A += np.float32(1e-3) * np.diag(np.diag(A))
        A[np.triu_indices(6, 1)] += rng.normal(size=15).astype(np.float32) * np.float32(1e-3)
        out.append((A, rng.normal(size=6).astype(np.float32)))
    return out


def not_positive_definite():
    """A rank-5 J J^T: positive semi-definite, not positive definite after
    rounding (LAPACK's Cholesky fails at pivot 6); b in its range."""
    rng = np.random.default_rng(0)
    J = rng.normal(size=(6, 5)).astype(np.float32)
    A = (J @ J.T).astype(np.float32)
    return A, (A @ rng.normal(size=6).astype(np.float32)).astype(np.float32)


def tangents(n: int = 100_000, seed: int = 0) -> np.ndarray:
    """[upsilon, omega]; half the rotations scaled under the small-angle
    threshold (|omega|^2 <= 1e-8)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.3, (n, 6)).astype(np.float32)
    small = np.arange(n) % 2 == 0
    w = xi[small, 3:]
    xi[small, 3:] = (w * (rng.uniform(0, 1e-4, (len(w), 1)) / np.linalg.norm(w, axis=1, keepdims=True))
                     ).astype(np.float32)
    return xi


def _jax():
    import jax

    return jax


def test_solve6_bit_equal_to_jax():
    from weiner_slamit_v2_tpu.optim.pose_opt import solve6 as j_solve6

    f = _jax().jit(j_solve6)
    for A, b in spd_systems():
        x = pose_opt.solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(x, np.asarray(f(A, b)))


def test_solve6_not_positive_definite():
    """JAX's clamped pivot gives a finite step (the LM's cost test then
    decides); the port's solve gives the same bits. LAPACK's
    ``cholesky_ex`` reports the failed pivot here."""
    from weiner_slamit_v2_tpu.optim.pose_opt import solve6 as j_solve6

    A, b = not_positive_definite()
    assert int(torch.linalg.cholesky_ex(torch.from_numpy(A.astype(np.float32)))[1]) > 0
    xj = np.asarray(_jax().jit(j_solve6)(A, b))
    assert np.isfinite(xj).all()
    np.testing.assert_array_equal(pose_opt.solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy(), xj)


def test_exp_bit_equal_to_jax():
    from weiner_slamit_v2_tpu.geometry import se3 as jse3

    xi = tangents()
    f = _jax().jit(jse3.exp)
    ref = np.stack([np.asarray(f(x)) for x in xi])
    np.testing.assert_array_equal(se3.exp(torch.from_numpy(xi)).numpy(), ref)


def _lm_trace(Tcw0, X, uv, inv_sigma2, valid, K, n_rounds=4, n_iters=10, lambda_init=1e-3):
    """The monocular optimize_pose of the JAX package, also returning every
    LM iteration's H, lam, damped matrix, b, step, pose and updated pose."""
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.geometry import se3 as jse3
    from weiner_slamit_v2_tpu.optim import pose_opt as jpo

    jax = _jax()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    delta2 = th = jpo.CHI2_MONO

    def chi2_of(Tcw):
        ru, rv, _, _, z = jpo._residuals_jacobian_soa(Tcw, X, uv, fx, fy, cx, cy)
        return (ru * ru + rv * rv) * inv_sigma2, z

    def robust_cost(chi2, z, mask, robust):
        rho = jnp.where((chi2 <= delta2) | ~robust, chi2,
                        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2)
        return jnp.sum(jnp.where(mask & (z > 0), rho, 0.0))

    n = n_rounds * n_iters
    rec = dict(H=jnp.zeros((n, 6, 6)), lam=jnp.zeros(n), Hd=jnp.zeros((n, 6, 6)), b=jnp.zeros((n, 6)),
               dx=jnp.zeros((n, 6)), T=jnp.zeros((n, 4, 4)), Tn=jnp.zeros((n, 4, 4)))
    Tcw, inl = Tcw0, valid
    for rnd in range(n_rounds):
        robust = jnp.asarray(rnd < 2)

        def lm_step(it, state, rnd=rnd, robust=robust, inl=inl):
            Tcw, lam, rec = state
            ru, rv, Ju, Jv, z = jpo._residuals_jacobian_soa(Tcw, X, uv, fx, fy, cx, cy)
            chi2 = (ru * ru + rv * rv) * inv_sigma2
            wr = jnp.where(chi2 <= delta2, 1.0, jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))
            w = jnp.where(inl & (z > 0), inv_sigma2 * jnp.where(robust, wr, 1.0), 0.0)
            Juw, Jvw = Ju * w, Jv * w
            H = Juw @ Ju.T + Jvw @ Jv.T
            b = -(Juw @ ru + Jvw @ rv)
            cost0 = robust_cost(chi2, z, inl, robust)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            dx = jpo.solve6(Hd, b)
            T_new = jse3.retract(Tcw, dx)
            c_new, z_new = chi2_of(T_new)
            cost1 = robust_cost(c_new, z_new, inl, robust)
            accept = (cost1 < cost0) & jnp.isfinite(cost1) & jnp.all(jnp.isfinite(dx))
            j = rnd * n_iters + it
            now = dict(H=H, lam=lam, Hd=Hd, b=b, dx=dx, T=Tcw, Tn=T_new)
            rec = {k: v.at[j].set(now[k]) for k, v in rec.items()}
            Tcw = jnp.where(accept, T_new, Tcw)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
            return Tcw, lam, rec

        Tcw, _, rec = jax.lax.fori_loop(0, n_iters, lm_step, (Tcw, jnp.float32(lambda_init), rec))
        chi2, z = chi2_of(Tcw)
        inl = valid & (chi2 <= th) & (z > 0)
    return jse3.orthonormalize(Tcw), inl, rec


def pose_problem():
    """tests/test_torch_map.py's pose problem: 300 points, 20 outliers."""
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.geometry import se3 as jse3

    rng = np.random.default_rng(5)
    n = 300
    K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.03, 0.02], jnp.float32)))
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * 300.0 + np.array([159.5, 119.5])
    uv += rng.normal(0, 0.7, uv.shape)
    uv[:20] += rng.uniform(-40, 40, (20, 2))
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    valid = rng.random(n) > 0.05
    T0 = np.asarray(jse3.exp(jnp.asarray([0.03, 0.0, 0.05, 0.0, 0.0, 0.0], jnp.float32))) @ T_true
    return [a.astype(np.float32) for a in (T0, X, uv)] + [inv_s2, valid, K]


def test_lm_internals_equal_inside_the_pose_program():
    import jax.numpy as jnp
    from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose as j_optimize_pose

    jax = _jax()
    args = [jnp.asarray(a) for a in pose_problem()]
    T_real, inl_real, _ = j_optimize_pose(*args, lambda_init=1e-4)
    T_copy, inl_copy, rec = jax.jit(_lm_trace, static_argnames=("n_rounds", "n_iters"))(
        *args, lambda_init=1e-4)
    # the instrumented copy computes what the real program does
    np.testing.assert_array_equal(np.asarray(T_copy), np.asarray(T_real))
    np.testing.assert_array_equal(np.asarray(inl_copy), np.asarray(inl_real))
    rec = {k: torch.from_numpy(np.array(v)) for k, v in rec.items()}
    for j in range(rec["H"].shape[0]):
        H, lam = rec["H"][j], rec["lam"][j]
        Hd = fma(lam, torch.diag(torch.diag(H)), H) + 1e-9 * torch.eye(6)
        # solve6 reads the lower triangle only
        assert torch.equal(torch.tril(Hd), torch.tril(rec["Hd"][j])), j
        assert torch.equal(pose_opt.solve6(rec["Hd"][j], rec["b"][j]), rec["dx"][j]), j
        assert torch.equal(se3.retract(rec["T"][j], rec["dx"][j]), rec["Tn"][j]), j


@pytest.mark.cuda
def test_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for A, b in spd_systems(100) + [not_positive_definite()]:
        A, b = torch.from_numpy(A), torch.from_numpy(b)
        assert torch.equal(pose_opt.solve6(A.cuda(), b.cuda()).cpu(), pose_opt.solve6(A, b))
    xi = torch.from_numpy(tangents())
    assert torch.equal(se3.exp(xi.cuda()).cpu(), se3.exp(xi))
    R = se3.exp(xi[:1000])
    R[:, :3, :3] += 1e-4 * torch.randn(1000, 3, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(se3.orthonormalize(R.cuda()).cpu(), se3.orthonormalize(R))


@pytest.mark.cuda
def test_card_graph_tail_equals_eager():
    """The LM iteration's tail replayed as a CUDA graph gives the eager
    tail's bits, and so does the whole optimize_pose."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(3)
    n = 1024
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1)
    uv = X[:, :2] / X[:, 2:] * 500.0 + np.array([320.0, 240.0]) + rng.normal(0, 0.7, (n, 2))
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    args = [se3.exp(torch.tensor([0.05, 0.0, 0.03, 0.008, -0.004, 0.002])),
            torch.from_numpy(X.astype(np.float32)), torch.from_numpy(uv.astype(np.float32)),
            torch.ones(n), torch.ones(n, dtype=torch.bool), torch.from_numpy(K)]
    args = [a.cuda() for a in args]
    pose_opt.capture_tail("cuda")
    for A, b in spd_systems(20):
        H, bb = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        lam, T = torch.full((), 1e-3, device="cuda"), args[0]
        eager = pose_opt._lm_tail(H, bb, lam, T)
        graph = pose_opt._damped_step(H, bb, lam, T)
        assert all(torch.equal(e, g) for e, g in zip(eager, graph))
    with_graph = pose_opt.optimize_pose(*args)
    real = pose_opt._damped_step
    pose_opt._damped_step = pose_opt._lm_tail
    try:
        eager = pose_opt.optimize_pose(*args)
    finally:
        pose_opt._damped_step = real
    assert all(torch.equal(e, g) for e, g in zip(eager, with_graph))
