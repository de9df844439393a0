"""The port's map state, pose optimization and local-mapping pass against
the JAX package: state conversion, ``optimize_pose`` and one full
``mapping_step`` from a JAX map snapshot."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose as j_optimize_pose
from weiner_slamit_v2_tpu.slam_map import types as jtypes
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_tpu.tracking.system import _mapping_step_jit
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.optim.pose_opt import optimize_pose
from weiner_slamit_v2_torch.slam_map.convert import map_from_numpy, map_to_numpy
from weiner_slamit_v2_torch.tracking.local_mapping import mapping_step

torch.set_num_threads(1)

H, W = 240, 320


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest float32 distance in ulps between a and b."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max()) if ia.size else 0
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)


def small_config(mod):
    """tests/test_tracking.py's small_config, on the synchronous slice."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                k3=0, width=W, height=H),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(frames_per_sync=1, abortable_ba=False),
    )


def jmap_numpy(m):
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def jax_snapshot():
    """A JAX map at the moment a keyframe hands it to the mapper, plus the
    JAX mapping pass on it."""
    cfg = small_config(jconfig)
    seq = make_synthetic_sequence(n_frames=16, h=H, w=W, seed=11, motion="orbit", K=K)
    sys_ = JSystem(cfg, JCamera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H))
    snaps = []
    orig = sys_.tracker.mapping_hook

    def hook(kf):
        snaps.append((jmap_numpy(sys_.tracker.m), kf))
        orig(kf)

    sys_.tracker.mapping_hook = hook
    for f in seq.frames:
        sys_.track_monocular(f.image, f.timestamp)
    assert len(snaps) >= 3, len(snaps)
    arrays, kf = snaps[2]
    t = sys_.tracker
    m_in = jtypes.SlamMap(**{k: jnp.asarray(v) for k, v in arrays.items()})
    m_out = _mapping_step_jit(m_in, jnp.asarray(kf), t.K, t.scale_factors, t.sigma2,
                              t.inv_sigma2, cfg)
    consts = [np.asarray(a) for a in (t.K, t.scale_factors, t.sigma2, t.inv_sigma2)]
    return arrays, kf, jmap_numpy(m_out), consts


def test_convert_round_trip(jax_snapshot):
    arrays, *_ = jax_snapshot
    empty = jtypes.empty_map(jconfig.MapCapacityConfig(max_keyframes=4, max_map_points=64), 32)
    for src in (arrays, jmap_numpy(empty)):
        m = map_from_numpy(src, device="cpu")
        assert m.kf_desc.dtype == torch.int32
        back = map_to_numpy(m)
        assert set(back) == set(src)
        for k, v in src.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_optimize_pose_matches_jax():
    rng = np.random.default_rng(5)
    n = 300
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.03, 0.02], jnp.float32)))
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * 300.0 + np.array([159.5, 119.5])
    uv += rng.normal(0, 0.7, uv.shape)
    uv[:20] += rng.uniform(-40, 40, (20, 2))           # outliers
    octave = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** octave).astype(np.float32)
    valid = rng.random(n) > 0.05
    T0 = np.asarray(jse3.exp(jnp.asarray([0.03, 0.0, 0.05, 0.0, 0.0, 0.0], jnp.float32))) @ T_true
    args = [a.astype(np.float32) for a in (T0, X, uv)] + [inv_s2, valid, K]
    Tj, inl_j, n_j = j_optimize_pose(*[jnp.asarray(a) for a in args], lambda_init=1e-4)
    Tt, inl_t, n_t = optimize_pose(*[torch.from_numpy(np.asarray(a)) for a in args],
                                   lambda_init=1e-4)
    # not exact: the normal equations' sums (XLA's dot emitter) round in
    # another order; the damping, the 6x6 solve and the update are JAX's
    # (tests/test_torch_pose_solve.py). Measured on this input: 9 of the 16
    # entries differ, by at most 22 ulp (1.64e-7)
    Tt, Tj = Tt.numpy(), np.asarray(Tj)
    differ = Tt != Tj
    assert ulps(Tt[differ], Tj[differ]) <= 22, (Tt, Tj)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 200


def test_mapping_step_matches_jax(jax_snapshot):
    """One local-mapping pass on the same map. Integer planes equal: no
    float gate (chi2, epipolar, parallax, the BA's outlier classification)
    flips on this pass, as the fed-stage audit finds on every pass of the
    slice session (tests/test_torch_fed_stages.py). Keyframe poses after BA
    agree to 5e-5 (measured: 4.34e-5; the BA's sums are not XLA's order)."""
    arrays, kf, ref, consts = jax_snapshot
    cfg = small_config(tconfig)
    Kt, sf, s2, is2 = (torch.from_numpy(a) for a in consts)
    out = map_to_numpy(mapping_step(map_from_numpy(arrays, device="cpu"), kf, Kt, sf, s2, is2, cfg))
    for name in ("kf_obs", "mp_valid", "kf_valid"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert out["n_mp"] == ref["n_mp"]
    valid = ref["kf_valid"] & out["kf_valid"]
    np.testing.assert_allclose(out["kf_pose"][valid], ref["kf_pose"][valid], atol=5e-5)
    # the pass did real work: new points and a moved pose
    assert int(ref["n_mp"]) > int(arrays["n_mp"])
    assert not np.array_equal(ref["kf_pose"][kf], arrays["kf_pose"][kf])
