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


# sha256 of the shrunk frames (seed 2**31 + 5, 6 frames at a quarter of the
# fr1 size) as the monocular renderer drew them before planes could lie
# normal to x or y: the one cell's frames may not move
MONO_FRAMES_SHA256 = {
    "explore": "18cb40276a3c73daa25135f50cb6a7005cc5fb8be1470fdb07d1090baf9d4827",
    "kidnap": "4ef3e218dc298add8a8d1f788566fdc2bd2d0524ba8e2aad06b293debb4ae945",
}


@pytest.mark.parametrize("name", sorted(MONO_FRAMES_SHA256))
def test_the_monocular_frames_are_pinned(name):
    import hashlib

    tr = world.build_traffic(_traffic(name), CAM_FR1, "monocular", 2**31 + 5, "cpu", n_frames=6,
                             scale=0.25)
    assert hashlib.sha256(tr.images.tobytes()).hexdigest() == MONO_FRAMES_SHA256[name]
    assert tr.right_images is None and tr.depths is None


def _numpy_cast(planes, Tcw, fx, fy, cx, cy, h, w):
    """A plain ray cast, float64, pixel by pixel: (image, ray parameter at
    the nearest hit or inf)."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    C = -R.T @ t
    img, best = np.zeros((h, w)), np.full((h, w), np.inf)
    axes = {"x": (0, 2, 1), "y": (1, 0, 2), "z": (2, 0, 1)}
    for v in range(h):
        for u in range(w):
            d = R.T @ np.array([(u - cx) / fx, (v - cy) / fy, 1.0])
            for p in planes:
                a, iu, iv = axes[p.axis]
                if abs(d[a]) < 1e-9:
                    continue
                lam = (p.depth - C[a]) / d[a]
                if not (0.05 < lam < best[v, u]):
                    continue
                X = C + lam * d
                tex = p.texture.numpy().astype(np.float64)
                th, tw = tex.shape
                tu = (X[iu] - p.tex_center[0]) * p.ppm + tw / 2.0
                tv = (X[iv] - p.tex_center[1]) * p.ppm + th / 2.0
                best[v, u] = lam
                if 0 <= tu < tw - 1 and 0 <= tv < th - 1:
                    u0, v0 = int(np.floor(tu)), int(np.floor(tv))
                    du, dv = tu - u0, tv - v0
                    img[v, u] = (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u0 + 1] * du * (1 - dv)
                                 + tex[v0 + 1, u0] * (1 - du) * dv + tex[v0 + 1, u0 + 1] * du * dv)
                else:
                    img[v, u] = 0.0
    return img, best


STREET = {"planes": [
    {"axis": "y", "at": 1.65, "ppm": 20, "extent": [[-8.0, 8.0], [-5.0, 60.0]]},
    {"axis": "x", "at": -8.0, "ppm": 20, "extent": [[-5.0, 60.0], [-10.0, 1.65]]},
    {"axis": "x", "at": 8.0, "ppm": 20, "extent": [[-5.0, 60.0], [-10.0, 1.65]]},
    {"axis": "z", "at": 60.0, "ppm": 20, "extent": [[-8.0, 8.0], [-10.0, 1.65]]}]}


def test_planes_normal_to_x_and_y_agree_with_a_numpy_ray_cast():
    h, w, f = 24, 64, 40.0
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    planes = world.make_world(STREET, f, h, w, (0.0, 0.0), 11, "cpu")
    assert [p.axis for p in planes] == ["y", "x", "x", "z"]
    rays = torch.from_numpy(world.pinhole_rays(f, f, cx, cy, h, w))
    for twc, rot in [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)), ((1.2, -0.4, 7.3), (0.03, -0.3, 0.02))]:
        Tcw = _pose(twc, rot)
        img, lam = world.render(planes, Tcw[None], rays, with_depth=True)
        ref, ref_lam = _numpy_cast(planes, Tcw, f, f, cx, cy, h, w)
        hit = np.isfinite(ref_lam)
        assert hit.mean() > 0.5 and np.array_equal(hit, torch.isfinite(lam[0]).numpy())
        # float32 against float64: texture coordinates tens of meters out
        assert np.abs(lam[0].numpy()[hit] - ref_lam[hit]).max() < 1e-3 * ref_lam[hit].max()
        assert np.mean(np.abs(img[0].numpy() - ref) < 0.5) > 0.995


def test_stereo_and_depth_frames():
    cam = {"fx": 40.0, "fy": 40.0, "cx": 31.5, "cy": 11.5, "width": 64, "height": 24,
           "baseline_times_fx": 40.0 * 0.5, "fps": 10.0}
    spec = {"frames": 3, "warmup_keyframes": 1,
            "path": {"pos": [[0.0, 0.0, []], [0.0, 0.0, []], [0.0, 0.8, []]],
                     "rot": [[0.0, 0.0, []], [0.0, 0.0, []], [0.0, 0.0, []]]},
            "worlds": {"stereo": STREET, "rgbd": STREET}}
    st = world.build_traffic(spec, cam, "stereo", 5, "cpu")
    rd = world.build_traffic(spec, cam, "rgbd", 5, "cpu")
    assert st.right_images.shape == st.images.shape == (3, 24, 64) and st.depths is None
    assert rd.right_images is None and rd.depths.dtype == np.float32
    assert np.array_equal(st.images, rd.images)
    planes = world.make_world(STREET, 40.0, 24, 64, (0.0, 0.0), 5, "cpu")
    for i in range(3):
        # the right view is the left camera moved by the baseline along its own x
        Twc_r = st.gt_Twc[i].copy()
        Twc_r[:3, 3] += Twc_r[:3, :3] @ np.array([0.5, 0.0, 0.0])
        ref, _ = _numpy_cast(planes, np.linalg.inv(Twc_r), 40.0, 40.0, 31.5, 11.5, 24, 64)
        assert np.mean(np.abs(st.right_images[i].astype(float) - np.clip(ref, 0, 255)) <= 1) > 0.99
        # the depth is the camera z of the nearest hit
        _, lam = _numpy_cast(planes, np.linalg.inv(rd.gt_Twc[i]), 40.0, 40.0, 31.5, 11.5, 24, 64)
        hit = np.isfinite(lam)
        assert np.allclose(rd.depths[i][hit], lam[hit], rtol=1e-4) and (rd.depths[i][~hit] == 0).all()


def test_a_stereo_camera_with_a_lens_is_refused():
    spec = {"frames": 2, "warmup_keyframes": 1, "path": _traffic("explore")["path"],
            "worlds": {"stereo": {"planes": [{"depth": 4.0}]}}}
    with pytest.raises(ValueError, match="rectified"):
        world.build_traffic(spec, {**CAM_FR1, "baseline_times_fx": 40.0}, "stereo", 1, "cpu",
                            scale=0.1)
