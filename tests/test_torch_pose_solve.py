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

The ``cuda`` cases hold the card's solve and exponential against the CPU
port's, and the pose LM's kernel (csrc/pose_lm.cu) against the plain form on
the card and the float64 reference LM; they import no JAX:
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


def card_problem(case: str):
    """optimize_pose's arguments (CPU tensors) and keyword arguments for a
    case of the kernel tests: points 3-8 m ahead seen at 0.7 px noise, 5 %
    outliers, octaves 0-3, 5 % of the observations invalid."""
    n = 1000 if case == "n_1000" else 1024
    rng = np.random.default_rng(3)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1)
    uv = X[:, :2] / X[:, 2:] * 500.0 + np.array([320.0, 240.0]) + rng.normal(0, 0.7, (n, 2))
    out = rng.random(n) < 0.05
    uv[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    valid = rng.random(n) > 0.05
    kw = {}
    if case == "stereo":   # 60 % with a right-u, the rest monocular rows
        ur = (uv[:, 0] - 40.0 / X[:, 2] + rng.normal(0, 0.5, n)).astype(np.float32)
        ur[rng.random(n) < 0.4] = -1.0
        kw = dict(ur=torch.from_numpy(ur), bf=40.0)
    if case == "all_invalid":
        valid[:] = False
    if case == "behind_camera":
        X[:100, 2] *= -1.0
    if case == "short":
        kw = dict(n_rounds=2, n_iters=3)
    # far off, the robust rounds reject steps from their fifth iteration on
    xi = [0.6, -0.3, 0.8, 0.25, -0.2, 0.1] if case == "far_start" else [0.05, 0.0, 0.03, 0.008, -0.004, 0.002]
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    args = [se3.exp(torch.tensor(xi)), torch.from_numpy(X.astype(np.float32)),
            torch.from_numpy(uv.astype(np.float32)),
            torch.from_numpy((1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)),
            torch.from_numpy(valid), torch.from_numpy(K)]
    return args, kw


KERNEL_CASES = ["mono_1024", "stereo", "n_1000", "all_invalid", "behind_camera", "far_start", "short"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _to(dev, args, kw):
    return [a.to(dev) for a in args], {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_card_kernel_matches_eager(case):
    """The kernel (one launch) against the plain form on the card: the pose
    within 5e-5 of its largest entry, the inlier masks equal except where a
    feature's chi2 lies within 1e-4 of its threshold, and the float64
    reference LM's cost excess at the kernel's pose under 1e-4. The two sum
    H, b and the costs in different orders, and the float32 LM's pose moves
    with the order alone: the plain form on the CPU, fed these cases'
    observations permuted, moves by up to 1.2e-5 of the largest entry
    (``far_start``, ``short``)."""
    from slambench.reference import stages

    from weiner_slamit_v2_torch.ops import pose_lm_kernel

    dev = _card()
    args, kw = _to(dev, *card_problem(case))
    n0 = pose_lm_kernel.launches
    T, inl, n_inl = pose_opt.optimize_pose(*args, **kw)
    assert pose_lm_kernel.launches == n0 + 1
    Te, inl_e, _ = pose_opt.optimize_pose_plain(*args, **kw)
    assert (T.dtype, inl.dtype, n_inl.dtype) == (torch.float32, torch.bool, torch.int64)
    assert (T.shape, inl.shape, n_inl.shape) == ((4, 4), args[1].shape[:1], ())
    assert int(n_inl) == int(inl.sum())
    assert float((T - Te).abs().max()) <= 5e-5 * float(Te.abs().max())
    X, uv, w, valid, K = (a.cpu() for a in args[1:])
    ur = kw["ur"].cpu() if "ur" in kw else None
    bf = kw.get("bf", 0.0)
    chi2 = stages.pose_chi2(Te.cpu().double()[None], X.double()[None], uv.double()[None],
                            w.double()[None], K.double(), None if ur is None else ur.double()[None],
                            bf)[0][0]
    th = torch.where(ur >= 0, pose_opt.CHI2_STEREO, pose_opt.CHI2_MONO) if ur is not None else \
        torch.full_like(chi2, pose_opt.CHI2_MONO)
    differ = inl.cpu() != inl_e.cpu()
    assert bool(((chi2 - th).abs() <= 1e-4 * th)[differ].all()), int(differ.sum())
    rounds = {k: v for k, v in kw.items() if k in ("n_rounds", "n_iters")}
    T_ref, inl_ref = stages.pose_lm(args[0].cpu()[None], X[None], uv[None], w[None], valid[None], K,
                                    torch.tensor([1e-3]), ur=None if ur is None else ur[None], bf=bf,
                                    **rounds)
    e = stages.pose_cost_excess(T.cpu()[None], T_ref, inl_ref, X[None], uv[None], w[None], K,
                                None if ur is None else ur[None], bf)
    assert float(e[0]) < 1e-4, float(e[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mono_1024", "stereo"])
def test_card_kernel_repeats_bit_for_bit(case):
    """Two launches on the same inputs give the same bits: the kernel sums in
    a fixed order, with no atomics."""
    args, kw = _to(_card(), *card_problem(case))
    a, b = pose_opt.optimize_pose(*args, **kw), pose_opt.optimize_pose(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_card_raises_without_the_build(monkeypatch, tmp_path):
    """With no library built and no nvcc, optimize_pose on the card raises:
    it never falls back to the plain form."""
    from weiner_slamit_v2_torch.ops import cuda_build, pose_lm_kernel

    args, kw = _to(_card(), *card_problem("mono_1024"))

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    n0 = pose_lm_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pose_opt.optimize_pose(*args, **kw)
    assert pose_lm_kernel.launches == n0


def test_kernel_signature_matches_the_source():
    """The ctypes argtypes of pose_lm_launch have one entry per parameter of
    its extern "C" declaration in csrc/pose_lm.cu."""
    import os
    import re

    from weiner_slamit_v2_torch.ops import cuda_build

    src = open(os.path.join(cuda_build.CSRC, "pose_lm.cu")).read()
    params = re.search(r'extern "C" int pose_lm_launch\(([^)]*)\)', src).group(1)
    assert len(cuda_build.SIGNATURES["pose_lm_launch"]) == len(params.split(","))


def _wrong(what: str):
    args, _ = card_problem("short")
    args = [a[:60] if a.dim() and a.shape[0] == 1024 else a for a in args]
    if what == "dtype":
        args[1] = args[1].double()
    elif what == "shape":
        args[2] = torch.zeros(60, 3)
    elif what == "contiguity":
        args[1] = args[1].t().contiguous().t()
    return args


@pytest.mark.parametrize("what,match", [("dtype", "X must be"), ("shape", "uv must be"),
                                        ("contiguity", "not contiguous"), ("device", "CUDA device")])
def test_wrapper_rejects_what_the_kernel_does_not_take(what, match):
    """pose_lm checks dtype, shape and contiguity before it looks at the
    device, and takes CUDA tensors only; nothing is launched."""
    from weiner_slamit_v2_torch.ops import pose_lm_kernel

    n0 = pose_lm_kernel.launches
    with pytest.raises(ValueError, match=match):
        pose_lm_kernel.pose_lm(*_wrong(what), n_rounds=4, n_iters=10, chi2_th=pose_opt.CHI2_MONO,
                               lambda_init=1e-3)
    assert pose_lm_kernel.launches == n0


@pytest.mark.parametrize("case", ["mono", "stereo"])
def test_cpu_takes_the_plain_form(case):
    """On the CPU optimize_pose is the plain form, bit for bit, and launches
    nothing."""
    from weiner_slamit_v2_torch.ops import pose_lm_kernel

    args, kw = card_problem("stereo" if case == "stereo" else "mono_1024")
    args = [a[:80] if a.dim() and a.shape[0] == 1024 else a for a in args]
    kw = {k: v[:80] if torch.is_tensor(v) else v for k, v in kw.items()}
    n0 = pose_lm_kernel.launches
    got, want = pose_opt.optimize_pose(*args, **kw), pose_opt.optimize_pose_plain(*args, **kw)
    assert pose_lm_kernel.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
