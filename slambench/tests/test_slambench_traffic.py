"""The benchmark's traffic generator and frame-time arithmetic, on the CPU."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import harness, world

HERE = Path(__file__).resolve().parent.parent
CAM_FR1 = json.loads((HERE / "configs" / "tum_fr1_mono.json").read_text())["camera"]


def _traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["explore", "kidnap"])
def test_frames_repeat_for_a_seed(name):
    cam, sensor = CAM_FR1, "monocular"
    a = world.build_traffic(_traffic(name), cam, sensor, 2**31 + 5, "cpu", n_frames=6, scale=0.25)
    b = world.build_traffic(_traffic(name), cam, sensor, 2**31 + 5, "cpu", n_frames=6, scale=0.25)
    c = world.build_traffic(_traffic(name), cam, sensor, 2**31 + 6, "cpu", n_frames=6, scale=0.25)
    assert a.images.dtype == np.uint8 and a.images.shape == (6, 120, 160)
    assert np.array_equal(a.images, b.images) and np.array_equal(a.gt_Twc, c.gt_Twc)
    assert not np.array_equal(a.images, c.images)   # the seed draws the texture


def test_texture_is_the_originals():
    from weiner_slamit_v2_torch.io.datasets import _perlin_texture

    a = world.perlin_texture(90, 130, np.random.default_rng(3))
    b = _perlin_texture(90, 130, np.random.default_rng(3))
    assert np.array_equal(a, b)


def _pose(twc, rot):
    Twc = np.eye(4)
    Twc[:3, :3] = world.so3_exp_f32(np.asarray(rot))
    Twc[:3, 3] = twc
    return np.linalg.inv(Twc)


def test_plane_render_agrees_with_the_numpy_original():
    from weiner_slamit_v2_torch.io.datasets import SyntheticWorld, _perlin_texture

    h, w, f = 60, 80, 62.5
    K = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]], np.float32)
    tex = _perlin_texture(int(h * 2.5), int(w * 2.5), np.random.default_rng(0))
    orig = SyntheticWorld(texture=tex, K=K, plane_depth=4.0, pixels_per_meter=f / 4.0)
    plane = world.Plane(torch.from_numpy(tex), 4.0, (0.0, 0.0), f / 4.0)
    rays = torch.from_numpy(world.pinhole_rays(f, f, w / 2 - 0.5, h / 2 - 0.5, h, w))
    for twc, rot in [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)), ((0.3, 0.05, 0.1), (0.02, -0.05, 0.01))]:
        Tcw = _pose(twc, rot)
        a = orig.render(Tcw, h, w)
        b = world.render([plane], Tcw[None], rays)[0].numpy()
        assert np.abs(a - b).max() < 1e-2


def test_lens_rays_invert_the_distortion():
    cam = {k: CAM_FR1[k] for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "p1", "p2")}
    rays = world.lens_rays(cam, 48, 64).astype(np.float64)
    x, y = rays[..., 0], rays[..., 1]
    r2 = x * x + y * y
    radial = 1 + r2 * (cam["k1"] + r2 * (cam["k2"] + r2 * cam["k3"]))
    xd = x * radial + 2 * cam["p1"] * x * y + cam["p2"] * (r2 + 2 * x * x)
    us = np.arange(64)[None, :] * np.ones((48, 1))
    assert np.abs(cam["fx"] * xd + cam["cx"] - us).max() < 1e-3


def test_kidnap_schedule_is_a_function_of_the_frame_index():
    kid = _traffic("kidnap")["kidnap"]
    blank, s = world.kidnap_schedule(kid, 400)
    blank2, s2 = world.kidnap_schedule(kid, 250)
    assert np.array_equal(blank[:250], blank2) and np.array_equal(s[:250], s2)
    covered = np.flatnonzero(blank)
    assert covered[0] == kid["start"] + kid["offset"]
    assert np.array_equal(covered[:6], [142, 143, 144, 182, 183, 184])
    # every period holds the same covers, and each ends in a jump of a third of a lap
    per = [int(blank[a:a + kid["period"]].sum()) for a in range(kid["start"], 360, kid["period"])]
    assert set(per) == {kid["blank"]}
    assert s[145] - s[144] == 1 + kid["jump"] and s[144] - s[143] == 1
    # the jumped-to place lies on the mapped loop
    assert (s[145] % 112) == (145 + 37) % 112


def test_frame_ms_counts_a_stall_and_the_tail_takes_every_frame():
    lat = [0.1] * 19 + [2.0]
    window = sum(lat)
    frame_ms, tail = harness.frame_times(lat, window)
    assert frame_ms == pytest.approx(1e3 * 3.9 / 20)
    assert tail == pytest.approx(np.percentile(1e3 * np.asarray(lat), 92))
    # a stall between calls (host work of the window) counts too
    assert harness.frame_times(lat, window + 1.0)[0] == pytest.approx(1e3 * 4.9 / 20)
    lat2 = [0.1] * 10 + [0.5] * 10
    assert harness.frame_times(lat2, sum(lat2))[1] == pytest.approx(500.0)


@pytest.mark.parametrize("period", [8, 9, 10])
@pytest.mark.parametrize("first", range(10))
def test_the_tail_lies_among_the_keyframe_frames(period, first):
    """A keyframe frame every 8-10 frames: the 92nd percentile stays among
    them at every window length from 100 frames, whatever the phase."""
    for n in range(100, 220):
        lat = [0.59 if i >= first and (i - first) % period == 0 else 0.32 for i in range(n)]
        assert harness.frame_times(lat, sum(lat))[1] == pytest.approx(590.0), n
