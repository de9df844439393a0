"""The start of chip_smoke.py's stereo loop circle (phase 13) at a quarter of
its pixels (320x240, f 250, 512 features, the baseline kept at 0.12 m), every
second frame, so that the image moves ~26 px a frame as it does on the card
at 640x480. The JAX System and the port's lose the first frame after the
stereo initialization alike: with no velocity yet, the motion model searches
its 7 px window at the last pose, finds spurious matches (enough that the
reference-keyframe match is not tried), the pose optimization keeps a few
inliers, and the one-keyframe session resets and initializes again on the
next frame. The port's tracking cascade is JAX's; JAX's departs here from
the reference, which tracks the reference keyframe whenever the velocity is
empty (Tracking::Track)."""

import threading
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_reloc import use_jax_draws

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W, F = 240, 320, 250.0
BF = 0.12 * F
FRAMES = [0, 2, 4, 6]


def stereo_config(mod):
    """chip_smoke.py phase 13's config at 320x240 (loop closing off: the
    first frames do not reach it)."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=512), sensor="stereo",
        camera=mod.CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0, k3=0,
                                width=W, height=H, baseline_times_fx=BF,
                                depth_threshold=cs.DEPTH_THRESHOLD),
        tracking=mod.TrackingConfig(mapping_latency_frames=8, frames_per_sync=1),
    )


def run(sys_, pairs, out: list, no_velocity=None):
    for k, (left, right) in enumerate(pairs):
        if no_velocity is not None:
            t = sys_.tracker
            no_velocity.append(t.state == "OK" and t.velocity is None)
        o = sys_.track_stereo(left, right, k / 30.0)
        out.append((o.state, int(o.n_inliers), bool(o.created_kf)))


@pytest.fixture(scope="module")
def runs():
    L = cs.LOOP
    with mock.patch.dict(cs.WORKLOAD, H=H, W=W, f=F):
        seq = cs.loop_sequence(L["n_frames"], L["radius"], L["laps"], L["depth"], L["seed"],
                               L["start_wedge"], baseline=BF / F)
    pairs = [(cs.uint8(seq.frames[i].image), cs.uint8(seq.frames[i].image_right)) for i in FRAMES]
    j_out, t_out, no_velocity = [], [], []
    js = JSystem(stereo_config(jconfig), JCamera.create(F, F, W / 2, H / 2, width=W, height=H))
    worker = threading.Thread(target=run, args=(js, pairs, j_out))
    worker.start()
    cfg = stereo_config(tconfig)
    ts = System(cfg, Camera.create(F, F, W / 2, H / 2, width=W, height=H), device="cpu")
    use_jax_draws(ts.tracker, cfg.seed)
    run(ts, pairs, t_out, no_velocity)
    worker.join()
    return j_out, t_out, no_velocity, ts


def test_both_lose_the_first_frame_after_the_stereo_initialization(runs):
    j_out, t_out, _, _ = runs
    assert [s for s, _, _ in j_out] == ["OK", "LOST", "OK", "OK"], j_out
    assert t_out == j_out


def test_the_loss_is_the_first_frame_without_velocity_and_resets(runs):
    _, t_out, no_velocity, ts = runs
    assert no_velocity[:3] == [False, True, False]
    assert t_out[1][1] < 10                    # inliers of the motion model's pose optimization
    assert ts.tracker.resets == 1
    # the next frame initializes again: a keyframe with a point per stereo depth
    assert t_out[2][2] and t_out[2][1] > 100
    assert all(s == "OK" for s, _, _ in t_out[2:])
    assert np.isfinite(ts.tracker.last_Tcw.numpy()).all()
