"""Whole RGB-D and stereo sessions, the port's System against the JAX
System on the same frames (the JAX package's sequences, its depth maps and
its vocabulary / PnP draws fed to the port's hooks): the runs of
tests/test_rgbd_stereo.py, TestRGBD and TestStereoKeyframeGate."""

import numpy as np
import pytest
import torch
from test_rgbd_stereo import synthetic_depth_for
from test_torch_reloc import use_jax_draws

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W, FX = 240, 320, 300.0
K = np.array([[FX, 0, 159.5], [0, FX, 119.5], [0, 0, 1]], np.float32)
ATE_BOUND, ATE_GAP = 0.08, 0.02


def small_config(mod, **cam):
    """tests/test_rgbd_stereo.py's small_config."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=FX, fy=FX, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                                width=W, height=H, **cam),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
    )


def run_pair(jcfg, tcfg, feed, n_frames):
    """Both Systems over the frames; per frame (state, created_kf, n_kf_host)."""
    out = []
    for sys_ in (JSystem(jcfg, JCamera.create(FX, FX, 159.5, 119.5, width=W, height=H)),
                 System(tcfg, Camera.create(FX, FX, 159.5, 119.5, width=W, height=H), device="cpu")):
        if isinstance(sys_, System):
            use_jax_draws(sys_.tracker, tcfg.seed)
        log = []
        for i in range(n_frames):
            r = feed(sys_, i)
            log.append((r.state, r.created_kf, sys_.tracker.n_kf_host))
        sys_.finish()
        out.append((sys_, log))
    return out


def metric_ates(seq, runs):
    ates = []
    for sys_, _ in runs:
        _, Twc = sys_.tracker.trajectory_Twc()
        ates.append(ate_rmse(Twc, seq.gt_Twc[-len(Twc):], align_scale=False))
    return ates


@pytest.fixture(scope="module")
def rgbd_runs():
    """TestRGBD's run: the planar orbit, exact depth maps, sensor left at
    "monocular" (the entry point chooses the RGB-D path)."""
    seq = make_synthetic_sequence(n_frames=16, h=H, w=W, seed=21, motion="orbit", K=K,
                                  plane_depth=4.0)
    depths = synthetic_depth_for(seq)
    feed = lambda s, i: s.track_rgbd(seq.frames[i].image, depths[i], seq.frames[i].timestamp)  # noqa: E731
    return seq, run_pair(small_config(jconfig), small_config(tconfig), feed, len(seq.frames))


@pytest.fixture(scope="module")
def stereo_runs():
    """TestStereoKeyframeGate's run: the occluding world, a 0.2 m baseline,
    sensor "stereo"."""
    cam = dict(baseline_times_fx=0.2 * FX, depth_threshold=8.0)
    seq = make_synthetic_sequence(n_frames=24, h=H, w=W, seed=31, motion="orbit", K=K,
                                  world="multi", stereo_baseline=0.2)
    feed = lambda s, i: s.track_stereo(seq.frames[i].image, seq.frames[i].image_right, i / 30.0)  # noqa: E731
    return seq, run_pair(small_config(jconfig, **cam).replace(sensor="stereo"),
                         small_config(tconfig, **cam).replace(sensor="stereo"), feed,
                         len(seq.frames))


def test_rgbd_session_matches_jax(rgbd_runs):
    """OK from frame 0 (depth initialization makes a keyframe at once) to the
    end, keyframes on the same frames, metric ATE close to the JAX one's."""
    seq, ((js, jlog), (ts, tlog)) = rgbd_runs
    assert [s for s, _, _ in tlog] == [s for s, _, _ in jlog] == ["OK"] * len(seq.frames)
    assert tlog[0][1] and tlog[0][2] == 1
    assert [c for _, c, _ in tlog] == [c for _, c, _ in jlog]
    assert ts.tracker.n_kf_host == js.tracker.n_kf_host and ts.n_keyframes() == js.n_keyframes()
    ates = metric_ates(seq, rgbd_runs[1])
    assert max(ates) < ATE_BOUND and abs(ates[0] - ates[1]) < ATE_GAP, ates
    # bf = 0: no right-u anywhere; every keyframe grew points from depth
    assert bool((ts.map.kf_ur == -1).all()) and ts.mapping_passes >= 2


def test_stereo_session_matches_jax(stereo_runs):
    """OK to the end, the same keyframe frames, at least 2 keyframes and more
    than 100 points (the depth-init state is left), metric ATE close to the
    JAX one's; keyframes carry right-u for the stereo BA rows."""
    seq, ((js, jlog), (ts, tlog)) = stereo_runs
    assert [s for s, _, _ in tlog] == [s for s, _, _ in jlog] == ["OK"] * len(seq.frames)
    assert [c for _, c, _ in tlog] == [c for _, c, _ in jlog]
    assert ts.tracker.n_kf_host == js.tracker.n_kf_host
    assert ts.n_keyframes() >= 2 and ts.n_map_points() > 100
    assert abs(ts.n_map_points() - js.n_map_points()) <= 0.05 * js.n_map_points()
    ates = metric_ates(seq, stereo_runs[1])
    assert max(ates) < ATE_BOUND and abs(ates[0] - ates[1]) < ATE_GAP, ates
    m = ts.map
    assert int((m.kf_ur[m.kf_valid] >= 0).sum()) > 100


def test_close_point_gate_forces_insert():
    """tests/test_rgbd_stereo.py::test_close_point_gate_forces_insert on the
    port: few tracked close points and many untracked ones force c1c even
    at a healthy inlier ratio; monocular never uses the gate."""
    cfg = small_config(tconfig, baseline_times_fx=0.2 * FX, depth_threshold=8.0)
    for sensor, want in (("stereo", True), ("rgbd", True), ("monocular", False)):
        sys_ = System(cfg.replace(sensor=sensor), Camera.create(FX, FX, 159.5, 119.5, width=W,
                                                               height=H), device="cpu")
        t = sys_.tracker
        t.n_kf_host, t.state, t.last_kf_frame, t.frame_id = 3, "OK", 0, 5
        t.m = t.m.replace(kf_valid=t.m.kf_valid.clone().index_fill_(0, torch.tensor([0]), True))
        assert t._need_new_keyframe(120, 120, 3, n_close_tracked=40, n_close_untracked=90) is want
        assert not t._need_new_keyframe(120, 120, 3, n_close_tracked=300, n_close_untracked=10)
