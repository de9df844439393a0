"""The distorted-lens path end to end: the port's System against the JAX
System through the reference's Pixel-4 lens (presets.py "pixel4": radial
and tangential distortion), at half its resolution with the intrinsics
halved (distortion acts on normalized coordinates, so the coefficients carry
over). The frames are the JAX package's renders warped into the distorted
image (each pixel samples the pinhole render at its undistorted position),
and both packages get the same frames. The JAX initializer's RANSAC draws
are fed to the port, as in tests/test_torch_slice.py."""

import threading

import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence as j_make_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera, pixel4_camera
from weiner_slamit_v2_torch.tracking.system import System

from chip_smoke import undistorted_grid, warp_through_lens
from test_torch_slice import jax_draws

torch.set_num_threads(1)

H, W = 240, 320
_P4 = pixel4_camera()
LENS = dict(fx=_P4.fx / 2, fy=_P4.fy / 2, cx=_P4.cx / 2, cy=_P4.cy / 2, k1=_P4.k1, k2=_P4.k2,
            p1=_P4.p1, p2=_P4.p2, k3=_P4.k3, width=W, height=H)
K = np.array([[LENS["fx"], 0, LENS["cx"]], [0, LENS["fy"], LENS["cy"]], [0, 0, 1]], np.float32)
SEQ = dict(n_frames=28, h=H, w=W, seed=11, motion="orbit", K=K)


def distort_frames(images, cam: Camera):
    """Each pinhole render warped into ``cam``'s distorted image
    (chip_smoke.py's warp, the one phase 20 uses)."""
    q = undistorted_grid(cam)
    assert q.min() >= 0 and q[:, 0].max() < W - 1 and q[:, 1].max() < H - 1   # no padding needed
    return warp_through_lens(images, q, H, W)


def distorted_config(mod):
    """tests/test_torch_slice.py's small_config through the lens."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(**LENS),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(frames_per_sync=1, abortable_ba=False),
    )


def run_jax(frames, out: dict):
    js = JSystem(distorted_config(jconfig), JCamera.create(**LENS))
    feats = []
    for name in ("_extract_track", "_extract_init"):
        fn = getattr(js.tracker, name)
        setattr(js.tracker, name, lambda img, fn=fn: feats.append(fn(img)) or feats[-1])
    states = [js.track_monocular(img, i / 30.0).state for i, img in enumerate(frames)]
    js.finish()
    out["jax"] = (js, states, feats)


@pytest.fixture(scope="module")
def runs():
    seq = j_make_sequence(**SEQ)
    frames = distort_frames([f.image for f in seq.frames], Camera.create(**LENS))
    # the JAX session (mostly XLA compiles) runs in a thread beside the port's
    out = {}
    worker = threading.Thread(target=run_jax, args=(frames, out))
    worker.start()
    cfg = distorted_config(tconfig)
    ts = System(cfg, Camera.create(**LENS), device="cpu")
    ts.tracker.init_draws = jax_draws(cfg.seed)
    t_feats, extract = [], ts.tracker._extract
    ts.tracker._extract = lambda img, init: t_feats.append(extract(img, init)) or t_feats[-1]
    t_states = [ts.track_monocular(img, i / 30.0).state for i, img in enumerate(frames)]
    ts.finish()
    worker.join()
    return seq, out["jax"], (ts, t_states, t_feats)


def test_the_lens_is_the_reference_device():
    cam = Camera.create(**LENS)
    b = cam.image_bounds()
    assert 0 < b[0] < 10 and W - 10 < b[1] < W and 0 < b[2] < 10 and H - 10 < b[3] < H
    assert (cam.k1, cam.p1, cam.p2) == (_P4.k1, _P4.p1, _P4.p2)


def test_every_frame_undistorts_as_jax(runs):
    """The JAX tracker's own extract (camera fields closed over, as XLA
    compiles it) and the port give the same keypoints and the same
    undistorted positions, bit for bit, on every frame."""
    _, (_, _, j_feats), (_, _, t_feats) = runs
    assert len(t_feats) == len(j_feats) == SEQ["n_frames"]
    for jf, tf in zip(j_feats, t_feats):
        np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
        np.testing.assert_array_equal(tf.xy_und.numpy(), np.asarray(jf.xy_und))
        assert (tf.xy_und != tf.xy).any()


def test_same_initialization_frame_and_no_loss(runs):
    _, (_, js, _), (_, ts, _) = runs
    init_j = js.index("OK")
    assert ts.index("OK") == init_j
    assert all(s == "OK" for s in js[init_j:])
    assert all(s == "OK" for s in ts[init_j:])


def test_keyframe_counts_close(runs):
    _, (jsys, _, _), (tsys, _, _) = runs
    assert abs(tsys.tracker.n_kf_host - jsys.tracker.n_kf_host) <= 2
    assert abs(tsys.n_keyframes() - jsys.n_keyframes()) <= 2
    assert tsys.mapping_passes >= 3


def test_trajectory_accuracy_close(runs):
    seq, (jsys, _, _), (tsys, _, _) = runs
    ates = []
    for sys_ in (jsys, tsys):
        _, Twc = sys_.tracker.trajectory_Twc()
        ates.append(ate_rmse(Twc, seq.gt_Twc[-len(Twc):]))
    assert ates[0] < 0.06 and ates[1] < 0.06, ates
    assert abs(ates[1] - ates[0]) < 0.02, ates
