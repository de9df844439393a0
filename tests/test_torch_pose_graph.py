"""The essential-graph optimizer, the port against the JAX package on the
same seeded inputs: the chain + loop graph of tests/test_loop.py::TestFixScale
with fix_scale both ways, through the dense and the PCG solver, a graph with
invalid and fixed vertices and padded edges, and the map-point correction.
Poses agree within 2e-4 (float32 Cholesky / CG against XLA's, 15-20 LM
iterations); with fix_scale every scale is 1 to the rotation rows' float32
norm (1e-6), as the JAX test asks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry import sim3 as jsim3
from weiner_slamit_v2_tpu.optim import pose_graph as jpg
from weiner_slamit_v2_torch.geometry import sim3
from weiner_slamit_v2_torch.optim import pose_graph

torch.set_num_threads(1)
ATOL = 2e-4


def t_(a):
    return torch.from_numpy(np.array(a))


def chain_with_bad_loop():
    """tests/test_loop.py:236-272: 5 poses in a chain, kf0 fixed, a loop edge
    measured with a 12 % scale error."""
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, 5):
        step = np.asarray(jse3.exp(jnp.asarray([0.3, 0, 0.02 * i, 0, 0.05, 0], jnp.float32)))
        poses.append((step @ poses[-1]).astype(np.float32))
    S = np.stack(poses)
    ei = np.array([0, 1, 2, 3, 0], np.int32)
    ej = np.array([1, 2, 3, 4, 4], np.int32)
    rel = [np.asarray(jsim3.compose(S[j], jsim3.inv(S[i]))) for i, j in zip(ei[:4], ej[:4])]
    bad = np.diag([1.12, 1.12, 1.12, 1.0]).astype(np.float32) @ np.asarray(
        jsim3.compose(S[4], jsim3.inv(S[0])))
    edge_S = np.stack(rel + [bad]).astype(np.float32)
    fixed = np.zeros(5, bool)
    fixed[0] = True
    return S, np.ones(5, bool), fixed, ei, ej, edge_S, np.ones(5, bool)


def random_graph(seed=4, K=12, E=30):
    """Vertices with random Sim3 poses (two invalid, two fixed), chain edges
    plus random ones with noisy measurements, some edges padded (-1) or
    marked invalid."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.3, (K, 7)).astype(np.float32)
    xi[:, 6] *= 0.3
    S = np.asarray(jsim3.exp(jnp.asarray(xi)))
    valid = np.ones(K, bool)
    valid[[5, 9]] = False
    fixed = np.zeros(K, bool)
    fixed[[0, 7]] = True
    ei = np.concatenate([np.arange(K - 1), rng.integers(0, K, E - K + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), rng.integers(0, K, E - K + 1)]).astype(np.int32)
    ei[-2] = -1
    truth = np.asarray(jsim3.exp(jnp.asarray(xi + rng.normal(0, 0.05, xi.shape).astype(np.float32))))
    meas = np.asarray(jax_rel(truth, ei, ej))
    ev = np.ones(E, bool)
    ev[3] = False
    return S, valid, fixed, ei, ej, meas.astype(np.float32), ev


def jax_rel(S, ei, ej):
    Sj = jnp.asarray(S)[np.maximum(ej, 0)]
    Si = jnp.asarray(S)[np.maximum(ei, 0)]
    return Sj @ jsim3.inv(Si)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_chain_with_bad_loop_matches_jax(solver, fix_scale):
    args = chain_with_bad_loop()
    want = np.asarray(jpg.optimize_pose_graph(*map(jnp.asarray, args), n_iters=15,
                                              fix_scale=fix_scale, solver=solver))
    got = pose_graph.optimize_pose_graph(*map(t_, args), n_iters=15, fix_scale=fix_scale,
                                         solver=solver)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    scales = sim3.scale_of(got).numpy()
    if fix_scale:
        np.testing.assert_allclose(scales, 1.0, atol=1e-6)
    else:   # the solver spreads the measured scale drift
        assert np.abs(scales - 1.0).max() > 0.01, scales


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_random_graph_with_invalid_and_fixed_vertices_matches_jax(solver):
    args = random_graph()
    S0 = args[0]
    want = np.asarray(jpg.optimize_pose_graph(*map(jnp.asarray, args), solver=solver))
    got = pose_graph.optimize_pose_graph(*map(t_, args), solver=solver).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    valid, fixed = args[1], args[2]
    # fixed and invalid vertices do not move; the free ones do
    np.testing.assert_array_equal(got[~valid | fixed], S0[~valid | fixed])
    assert np.abs(got[valid & ~fixed] - S0[valid & ~fixed]).max() > 1e-3


def test_correct_map_after_pose_graph_matches_jax():
    rng = np.random.default_rng(6)
    K, M = 6, 40
    S_old = np.asarray(jsim3.exp(jnp.asarray(rng.normal(0, 0.3, (K, 7)), jnp.float32)))
    S_new = np.asarray(jsim3.exp(jnp.asarray(rng.normal(0, 0.3, (K, 7)), jnp.float32)))
    pos = rng.normal(0, 2, (M, 3)).astype(np.float32)
    valid = rng.uniform(size=M) > 0.2
    ref = rng.integers(-1, K, M).astype(np.int32)
    args = (pos, valid, ref, S_old, S_new)
    want = np.asarray(jpg.correct_map_after_pose_graph(*map(jnp.asarray, args)))
    got = pose_graph.correct_map_after_pose_graph(*map(t_, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    untouched = ~valid | (ref < 0)
    np.testing.assert_array_equal(got[untouched], pos[untouched])


@pytest.mark.parametrize("definite", [True, False], ids=["positive-definite", "indefinite"])
def test_dense_solve_fails_where_jax_fails(definite):
    """Both packages solve the dense system by Cholesky (JAX:
    jax.scipy.linalg.solve, assume_a="pos"). On a system that is not
    positive definite JAX's solution is NaN, and the LM rejects the step;
    the port's is NaN too, not a step from the partial factor. Here one
    vertex's diagonal block is negated."""
    rng = np.random.default_rng(4)
    K, E = 5, 6
    A = rng.normal(0, 1, (K, 7, 7)).astype(np.float32)
    D = A @ A.transpose(0, 2, 1) + 7 * np.eye(7, dtype=np.float32)
    if not definite:
        D[2] = -D[2]
    Hij = rng.normal(0, 0.1, (E, 7, 7)).astype(np.float32)
    ei = np.array([0, 1, 2, 3, 0, 1], np.int32)
    ej = np.array([1, 2, 3, 4, 4, 3], np.int32)
    off_ok = np.array([1, 1, 1, 1, 1, 0], np.float32)
    b = rng.normal(0, 1, (K, 7)).astype(np.float32)
    args = (D, Hij, ei, ej, off_ok, b)
    want = np.asarray(jpg._solve_dense(*map(jnp.asarray, args)))
    got = pose_graph._solve_dense(*map(t_, args)).numpy()
    assert np.isfinite(want).all() == np.isfinite(got).all() == definite
    if definite:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    else:
        assert np.isnan(want).all() and np.isnan(got).all()
