"""The monocular slice end to end: the port's System against the JAX
System on the same synthetic sequence, with the JAX initializer's RANSAC
draws fed to the port (frames_per_sync=1, abortable_ba=False: the
synchronous configuration the port implements)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.frontend.initializer import N_RANSAC, SAMPLE_SIZE
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence as j_make_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W = 240, 320
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
SEQ = dict(n_frames=24, h=H, w=W, seed=11, motion="orbit", K=K)


def small_config(mod):
    """tests/test_tracking.py's small_config on the synchronous slice."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                k3=0, width=W, height=H),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(frames_per_sync=1, abortable_ba=False),
    )


def jax_draws(seed):
    """The JAX tracker's RANSAC draws: PRNGKey(cfg.seed + frame_id)."""
    def draws(frame_id, n_valid):
        d = jax.random.randint(jax.random.PRNGKey(seed + frame_id), (N_RANSAC, SAMPLE_SIZE),
                               0, max(int(n_valid), 1))
        return torch.from_numpy(np.asarray(d))
    return draws


@pytest.fixture(scope="module")
def runs():
    seq = j_make_sequence(**SEQ)
    cfg_j = small_config(jconfig)
    js = JSystem(cfg_j, JCamera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H))
    j_states = [js.track_monocular(f.image, f.timestamp).state for f in seq.frames]
    js.finish()

    cfg_t = small_config(tconfig)
    ts = System(cfg_t, Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H), device="cpu")
    ts.tracker.init_draws = jax_draws(cfg_t.seed)
    t_states = [ts.track_monocular(f.image, f.timestamp).state for f in seq.frames]
    ts.finish()
    return seq, (js, j_states), (ts, t_states)


def test_synthetic_images_match():
    a, b = j_make_sequence(**SEQ), make_synthetic_sequence(**SEQ)
    np.testing.assert_allclose(b.gt_Twc, a.gt_Twc, atol=1e-6)
    for fa, fb in zip(a.frames, b.frames):
        np.testing.assert_allclose(fb.image, fa.image, rtol=0, atol=1e-3)


def test_same_initialization_frame_and_no_loss(runs):
    _, (_, js), (_, ts) = runs
    init_j = js.index("OK")
    assert ts.index("OK") == init_j
    assert all(s == "OK" for s in js[init_j:])
    assert all(s == "OK" for s in ts[init_j:])


def test_keyframe_counts_close(runs):
    """The sessions part at the initialization (frame 2: its SVDs are
    LAPACK's in JAX and torch's here; tools/first_divergence_torch.py
    lists every stage). Measured: 8 keyframes created and 6 valid in both."""
    _, (jsys, _), (tsys, _) = runs
    assert abs(tsys.tracker.n_kf_host - jsys.tracker.n_kf_host) <= 2
    assert abs(tsys.n_keyframes() - jsys.n_keyframes()) <= 2
    assert tsys.mapping_passes >= 3


def test_trajectory_accuracy_close(runs):
    seq, (jsys, _), (tsys, _) = runs
    ates = []
    for sys_ in (jsys, tsys):
        _, Twc = sys_.tracker.trajectory_Twc()
        ates.append(ate_rmse(Twc, seq.gt_Twc[-len(Twc):]))
    # measured: 0.0233 m (JAX) and 0.0182 m (port)
    assert ates[0] < 0.06 and ates[1] < 0.06, ates
    assert abs(ates[1] - ates[0]) < 0.02, ates


def test_trajectory_export(runs, tmp_path):
    _, _, (tsys, _) = runs
    p = tmp_path / "traj.txt"
    tsys.save_trajectory_tum(str(p))
    lines = [l for l in open(p) if l.strip()]
    assert len(lines) == len(tsys.tracker.trajectory) and len(lines[0].split()) == 8
    kf = tmp_path / "kf.txt"
    tsys.save_keyframe_trajectory_tum(str(kf))
    assert len(open(kf).readlines()) == tsys.n_keyframes()


def test_every_configuration_constructs(tmp_path):
    """The depth entry points, the map checkpoints and loop closing work
    (ROADMAP A.10, A.12 and A.11 landed), and so does the pipelined mode: a
    frames_per_sync=4 System constructs and tracks a frame. The default
    TrackingConfig (abortable_ba=True, the staged pass) constructs."""
    cfg = small_config(tconfig)
    cam = Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H)
    staged = System(cfg.replace(tracking=tconfig.TrackingConfig()), cam, device="cpu")
    assert staged.cfg.tracking.abortable_ba and staged._n_ba_chunks == 2
    seq = make_synthetic_sequence(n_frames=2, h=H, w=W, seed=31, motion="orbit", K=K, world="multi",
                                  with_depth=True, stereo_baseline=0.2)
    f = seq.frames[0]
    out = staged.track_rgbd(f.image, f.depth, 0.0)
    assert out.state == "OK" and out.created_kf and staged.tracker.n_kf_host == 1
    p = tmp_path / "map.npz"
    staged.save_map(str(p))
    stereo = System(cfg.replace(camera=dataclasses.replace(cfg.camera, baseline_times_fx=60.0)),
                    cam, device="cpu")
    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)  # noqa: E731
    out = stereo.track_stereo(u8(f.image), u8(f.image_right), 0.0)
    assert out.state == "OK" and bool((stereo.tracker.m.kf_ur[0] >= 0).any())
    stereo.load_map(str(p))
    assert stereo.tracker.n_kf_host == 1 and stereo.tracker.state == "LOST"
    stereo.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    assert len(open(tmp_path / "kitti.txt").readline().split()) == 12
    looping = System(cfg, cam, device="cpu", enable_loop_closing=True)
    assert looping.loop_closer is not None and not looping.loop_closer.fix_scale
    pipelined = System(cfg.replace(tracking=tconfig.TrackingConfig(frames_per_sync=4, abortable_ba=False)),
                       cam, device="cpu")
    out = pipelined.track_rgbd(f.image, f.depth, 0.0)
    assert out.state == "OK" and out.created_kf and pipelined.tracker.n_kf_host == 1
