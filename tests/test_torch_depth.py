"""The depth modes' units, the port against the JAX package on the same numpy
inputs: the synthetic multi-plane world with depth and a right view, the
stereo matcher, the RGB-D depth lookup, the stereo rows of the pose LM and
of the local BA (solve_ba and its staged pieces), the keyframe freeze with
points from depth on tied depths, and the dataset presets."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_staged import port_problem

from weiner_slamit_v2_tpu import presets as jpresets
from weiner_slamit_v2_tpu.config import OrbConfig as JOrbConfig
from weiner_slamit_v2_tpu.config import SlamConfig as JSlamConfig
from weiner_slamit_v2_tpu.frontend.extractor import FrameFeatures as JFrameFeatures
from weiner_slamit_v2_tpu.frontend.extractor import OrbExtractor as JOrbExtractor
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence as j_make_sequence
from weiner_slamit_v2_tpu.ops import stereo as jstereo
from weiner_slamit_v2_tpu.optim import local_ba as jba
from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose as j_optimize_pose
from weiner_slamit_v2_tpu.slam_map import types as jtypes
from weiner_slamit_v2_tpu.tracking import tracker as jtracker
from weiner_slamit_v2_torch import presets as tpresets
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_torch.ops import stereo as tstereo
from weiner_slamit_v2_torch.optim import local_ba as tba
from weiner_slamit_v2_torch.optim.pose_opt import optimize_pose
from weiner_slamit_v2_torch.slam_map.convert import features_from_numpy, map_from_numpy
from weiner_slamit_v2_torch.tracking import tracker as ttracker

torch.set_num_threads(1)

H, W, FX = 240, 320, 300.0
K = np.array([[FX, 0, 159.5], [0, FX, 119.5], [0, 0, 1]], np.float32)
BF = np.float32(0.2 * FX)


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _t(a):
    return torch.from_numpy(np.array(a))


def port_feats(jfeats):
    return features_from_numpy(_np(jfeats), device="cpu")


def test_synthetic_depth_and_stereo_sequence_bit_equal():
    """Images, depth maps and right views of the occluding world with noise
    are bit-equal to the JAX package's (the noise drawn left image first,
    then right). The path's rotations are bit-equal on these frames too:
    XLA's float32 sin/cos and numpy's can part by one ulp at some angles,
    which the session tests avoid by feeding the JAX package's frames."""
    kw = dict(n_frames=5, h=H, w=W, seed=3, K=K, motion="orbit", world="multi",
              photometric_noise=2.0, with_depth=True, stereo_baseline=0.2)
    a, b = j_make_sequence(**kw), make_synthetic_sequence(**kw)
    np.testing.assert_array_equal(b.gt_Twc, a.gt_Twc)
    for fa, fb in zip(a.frames, b.frames):
        for name in ("image", "depth", "image_right"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y), name
        assert fb.timestamp == fa.timestamp
    assert (b.frames[0].depth > 0).all() and b.frames[0].depth.max() <= 6.0


def stereo_pair(seed=31):
    seq = j_make_sequence(n_frames=1, h=H, w=W, seed=seed, motion="orbit", K=K, world="multi",
                          photometric_noise=2.0, stereo_baseline=0.2, with_depth=True)
    f = seq.frames[0]
    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)  # noqa: E731
    return u8(f.image), u8(f.image_right), f.depth


def test_match_stereo_matches_jax():
    """One uint8 pair at 240x320: the matched mask exact; depth and u_right
    bit-equal (the stated tolerance, 1e-5 relative, is not needed: every SAD
    of an integer image is exact in float32)."""
    left, right, gt_depth = stereo_pair()
    ex = JOrbExtractor(JOrbConfig(n_features=256), (H, W))
    fl = ex(jnp.asarray(left, jnp.float32))
    fr = ex(jnp.asarray(right, jnp.float32))
    minz = np.float32(BF / FX)
    dj, uj = jstereo.match_stereo(fl, fr, jnp.asarray(left, jnp.float32),
                                  jnp.asarray(right, jnp.float32), jnp.asarray(BF),
                                  jnp.asarray(minz), jnp.asarray(ex.scales), 8)
    dt, ut = tstereo.match_stereo(port_feats(fl), port_feats(fr), torch.from_numpy(left).float(),
                                  torch.from_numpy(right).float(), float(BF), float(minz),
                                  torch.from_numpy(ex.scales), 8)
    dj, uj = np.asarray(dj), np.asarray(uj)
    ok = dj > 0
    assert ok.sum() > 80
    np.testing.assert_array_equal(dt.numpy() > 0, ok)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ut.numpy(), uj, rtol=1e-5, atol=0)
    # and the depths are right: the rendered depth at the keypoint
    xy = np.round(np.asarray(fl.xy)).astype(int)
    ref = gt_depth[xy[ok, 1], xy[ok, 0]]
    assert np.median(np.abs(dt.numpy()[ok] - ref)) < 0.15


def test_depth_from_depthmap_exact():
    """The JAX test's four features, then the 256 features of a frame on a
    depth map with holes (0): exact."""
    n = 4
    jf = JFrameFeatures(
        xy=jnp.asarray([[10.0, 10.0], [100.0, 50.0], [0.0, 0.0], [5.0, 5.0]]),
        xy_und=jnp.zeros((n, 2)), response=jnp.ones(n), angle=jnp.zeros(n),
        octave=jnp.zeros(n, jnp.int32), desc=jnp.zeros((n, 8), jnp.uint32),
        valid=jnp.asarray([True, True, True, False]))
    d = tstereo.depth_from_depthmap(port_feats(jf), torch.full((H, W), 3.5))
    assert d.tolist() == [3.5, 3.5, 3.5, -1.0]
    left, _, depth = stereo_pair(seed=32)
    depth = np.where(np.random.default_rng(0).random(depth.shape) < 0.2, 0.0, depth).astype(np.float32)
    ex = JOrbExtractor(JOrbConfig(n_features=256), (H, W))
    fl = ex(jnp.asarray(left, jnp.float32))
    dj = np.asarray(jstereo.depth_from_depthmap(fl, jnp.asarray(depth)))
    dt = tstereo.depth_from_depthmap(port_feats(fl), torch.from_numpy(depth)).numpy()
    assert (dj == -1).sum() > 10
    np.testing.assert_array_equal(dt, dj)


def stereo_observations(rng, n, T, X, frac_st=0.6, frac_out=0.1):
    """Pixels (n,2) and right-u (n,) of points X seen from T, with noise,
    outliers and -1 (no stereo) on part of them."""
    Pc = X @ T[:3, :3].T + T[:3, 3]
    uv = (Pc[:, :2] / Pc[:, 2:3]) * FX + K[:2, 2] + rng.normal(0, 0.5, (n, 2))
    ur = uv[:, 0] - BF / Pc[:, 2] + rng.normal(0, 0.5, n)
    out = rng.random(n) < frac_out
    uv[out] += rng.choice([-1, 1], (out.sum(), 2)) * rng.uniform(8, 20, (out.sum(), 2))
    ur = np.where(rng.random(n) < frac_st, ur, -1.0)
    return uv.astype(np.float32), ur.astype(np.float32)


def test_optimize_pose_stereo_rows_match_jax():
    """200 points, 60 % with a right-u, 10 % outliers, from a start 3 cm and
    ~1 degree off: the pose within 1e-4 and the inlier mask equal."""
    rng = np.random.default_rng(4)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 8, n)], 1)
    T = np.asarray(jse3.exp(jnp.asarray([0.05, -0.02, 0.03, 0.01, -0.02, 0.005])), np.float64)
    uv, ur = stereo_observations(rng, n, T, X)
    T0 = np.asarray(jse3.exp(jnp.asarray([0.03, -0.01, 0.01, 0.0, -0.005, 0.01])) @ jnp.asarray(T, jnp.float32))
    w = (1.2 ** (-2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    X = X.astype(np.float32)
    Tj, inl_j, nj = j_optimize_pose(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w),
                                    jnp.asarray(valid), jnp.asarray(K), ur=jnp.asarray(ur),
                                    bf=jnp.asarray(BF))
    Tt, inl_t, nt = optimize_pose(_t(T0), _t(X), _t(uv), _t(w), _t(valid), _t(K), ur=_t(ur),
                                  bf=float(BF))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj) and 0.7 * n < int(nt) < 0.95 * n
    np.testing.assert_allclose(Tt.numpy(), T, atol=5e-3)


def stereo_ba_problem():
    """A JAX BAProblem with the stereo planes: 5 cameras (the first fixed),
    300 points, 4 observations each, right-u on 60 % of them, 5 %
    outliers, poses and points perturbed."""
    rng = np.random.default_rng(9)
    C, P, O = 5, 300, 4
    poses = [np.eye(4)] + [np.asarray(jse3.exp(jnp.asarray(
        [0.15 * c, 0.02 * c, 0.05 * c, 0.0, -0.02 * c, 0.0])), np.float64) for c in range(1, C)]
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(3, 8, P)], 1)
    obs_cam = np.stack([rng.permutation(C)[:O] for _ in range(P)]).astype(np.int32)
    uv = np.zeros((P, O, 2), np.float32)
    ur = np.zeros((P, O), np.float32)
    for c in range(C):
        sel = obs_cam == c
        u, r = stereo_observations(rng, P, poses[c], X, frac_out=0.05)
        uv[sel] = np.broadcast_to(u[:, None], (P, O, 2))[sel]
        ur[sel] = np.broadcast_to(r[:, None], (P, O))[sel]
    noisy = [poses[0]] + [np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.004, 6))), np.float64) @ p
                          for p in poses[1:]]
    prob = jba.BAProblem(
        cam_pose=jnp.asarray(np.stack(noisy), jnp.float32), cam_fixed=jnp.arange(C) == 0,
        cam_valid=jnp.ones(C, bool), points=jnp.asarray(X + rng.normal(0, 0.02, X.shape), jnp.float32),
        point_valid=jnp.ones(P, bool), obs_cam=jnp.asarray(obs_cam), obs_uv=jnp.asarray(uv),
        obs_inv_sigma2=jnp.asarray((1.2 ** (-2 * rng.integers(0, 3, (P, O)))).astype(np.float32)),
        obs_valid=jnp.ones((P, O), bool), K=jnp.asarray(K), obs_ur=jnp.asarray(ur),
        obs_has_ur=jnp.asarray(ur >= 0), bf=jnp.asarray(BF))
    return prob


def test_stereo_ba_matches_jax():
    """solve_ba and the staged pieces (phase 1, two 5-iteration chunks,
    finalize) on a problem with stereo observations: poses and points
    within 1e-3 (tests/test_torch_staged.py's tolerance), the inlier
    classification equal; the staged pass equals the port's solve_ba bit
    for bit."""
    jprob = stereo_ba_problem()
    tprob = port_problem(jprob)
    jr = jba.solve_ba(jprob, 5, 10)
    tr = tba.solve_ba(tprob, 5, 10)
    np.testing.assert_allclose(tr.cam_pose.numpy(), np.asarray(jr.cam_pose), atol=1e-3)
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=1e-3)
    np.testing.assert_array_equal(tr.obs_inlier.numpy(), np.asarray(jr.obs_inlier))
    assert float(tr.final_cost) == pytest.approx(float(jr.final_cost), rel=1e-3)
    n_out = int((~np.asarray(jr.obs_inlier)).sum())
    assert 0 < n_out < 0.2 * jr.obs_inlier.size
    # the stereo rows change the answer: the same problem without them differs
    mono = tba.solve_ba(dataclasses.replace(tprob, obs_ur=None, obs_has_ur=None, bf=None), 5, 10)
    assert not torch.equal(mono.points, tr.points)

    cam, pts, lam, inl = tba.ba_phase1(tprob, n_iters=5)
    jc, jp, jl, ji = jba.ba_phase1(jprob, n_iters=5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ji))
    lam = tba.BA_LAMBDA_INIT
    for _ in range(2):
        cam, pts, lam = tba.ba_phase2_chunk(tprob, cam, pts, lam, inl, n_iters=5)
    staged = tba.ba_finalize(tprob, cam, pts)
    assert torch.equal(staged.cam_pose, tr.cam_pose) and torch.equal(staged.points, tr.points)
    assert torch.equal(staged.obs_inlier, tr.obs_inlier)


def test_freeze_kf_depth_tied_depths_match_jax():
    """A keyframe frozen from a frame with no rotation in the occluding
    world: every feature on a plane has the same depth, so which untracked
    features rank among the closest 100 is decided by the sort's tie order
    (stable in both). kf_obs, kf_ur and mp_valid exact, mp_pos to 1e-5."""
    seq = j_make_sequence(n_frames=2, h=H, w=W, seed=6, motion="strafe", K=K, world="multi",
                          with_depth=True)
    img, depth_map = seq.frames[0].image, seq.frames[0].depth
    ex = JOrbExtractor(JOrbConfig(n_features=256), (H, W))
    jf = ex(jnp.asarray(img))
    jf = jf.replace(xy_und=jf.xy)
    fd = jstereo.depth_from_depthmap(jf, jnp.asarray(depth_map))
    d = np.asarray(fd)
    assert (d > 0).sum() > 150 and len(np.unique(d[d > 0])) < 0.2 * (d > 0).sum()   # ties
    cfg = JSlamConfig(orb=JOrbConfig(n_features=256))
    jcam = JCamera.create(FX, FX, 159.5, 119.5, width=W, height=H)
    m0 = jtypes.empty_map(cfg.capacity, 256)
    m0, _ = jtracker._build_depth_init(m0, jf, fd, jcam, jnp.asarray(0), jnp.asarray(0.0, jnp.float32),
                                       jnp.asarray(ex.scales), jnp.asarray(BF))
    # half of the features tracked (the even ones), the rest free
    cur_obs = np.where(np.arange(256) % 2 == 0, np.asarray(m0.kf_obs[0]), -1).astype(np.int32)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[0, 3] = -0.01
    thr = np.float32(2.0)    # no feature is close: the rank < 100 rule decides
    mj, kj = jtracker._freeze_kf_depth(
        m0, jnp.asarray(Tcw), jf, jnp.asarray(cur_obs), jnp.asarray(1), jnp.asarray(0.1, jnp.float32),
        jnp.asarray(0), fd, jcam, jnp.asarray(thr), jnp.asarray(ex.scales), jnp.asarray(BF))
    mt_, kt = ttracker.freeze_kf_depth(
        map_from_numpy(_np(m0), device="cpu"), _t(Tcw), port_feats(jf), _t(cur_obs), 1, 0.1, 0,
        _t(d), Camera.create(FX, FX, 159.5, 119.5, width=W, height=H), float(thr),
        torch.from_numpy(ex.scales), float(BF))
    assert kt == int(kj) == 1
    a, b = _np(mj), {f.name: getattr(mt_, f.name).numpy() for f in dataclasses.fields(mt_)}
    for name in ("kf_obs", "kf_ur", "mp_valid", "mp_obs_kf", "mp_n_obs", "n_mp"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    np.testing.assert_allclose(b["mp_pos"], a["mp_pos"], atol=1e-5)
    created = int(a["n_mp"]) - int(np.asarray(m0.n_mp))
    assert 0 < created <= 100


@pytest.mark.parametrize("name", jpresets.preset_names())
def test_presets_match_jax(name):
    """Every dataset preset builds the same SlamConfig, field for field."""
    assert dataclasses.asdict(tpresets.preset(name)) == dataclasses.asdict(jpresets.preset(name))
    assert tpresets.preset_names() == jpresets.preset_names()
