"""The port's camera against the JAX package's, through every distorted
calibration the CLI ships (presets.py: the reference's Pixel-4, TUM fr1 and
fr2, EuRoC).

``undistort_points`` is held against the JAX method jitted with the camera's
fields closed over, as the tracker compiles it (tracker.py's extract): that
program's rounding is what a session sees, and it differs from the method
run op by op. The distortion API (``distort_normalized``, ``project``) is
held against the JAX methods run op by op, as JAX's own tests call them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import presets as jpresets
from weiner_slamit_v2_tpu.geometry import camera as jcamera
from weiner_slamit_v2_torch import presets
from weiner_slamit_v2_torch.geometry import camera

DISTORTED = ["pixel4", "tum_fr1", "tum_fr2", "euroc"]
FIELDS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "width", "height")


def _lens(name: str) -> dict:
    cc = presets.preset(name).camera
    return {f: getattr(cc, f) for f in FIELDS}


def _pixels(lens: dict, seed: int) -> np.ndarray:
    w, h = lens["width"], lens["height"]
    grid = np.stack(np.meshgrid(np.arange(0, w, 0.5), np.arange(0, h, 0.5)), -1).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    rand = np.stack([rng.uniform(-20, w + 20, 20_000), rng.uniform(-20, h + 20, 20_000)], -1)
    return np.concatenate([grid, rand]).astype(np.float32)


@pytest.mark.parametrize("name", DISTORTED)
def test_undistort_points_matches_the_compiled_jax(name):
    lens = _lens(name)
    assert any(lens[k] != 0 for k in ("k1", "k2", "p1", "p2", "k3"))
    jcam, cam = jcamera.Camera.create(**lens), camera.Camera.create(**lens)
    uv = _pixels(lens, DISTORTED.index(name))
    want = np.asarray(jax.jit(lambda x: jcam.undistort_points(x))(jnp.asarray(uv)))
    got = cam.undistort_points(torch.from_numpy(uv)).numpy()
    assert got.dtype == np.float32 and got.shape == uv.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["bench", "kitti_00"])
def test_undistort_without_distortion_matches_the_compiled_jax(name):
    """No distortion: XLA still divides by fx as a product with its float32
    reciprocal, and the port does the same."""
    lens = (dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
            if name == "bench" else _lens(name))
    jcam, cam = jcamera.Camera.create(**lens), camera.Camera.create(**lens)
    uv = np.random.default_rng(7).uniform(0, 640, (50_000, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jcam.undistort_points(x))(jnp.asarray(uv)))
    np.testing.assert_array_equal(cam.undistort_points(torch.from_numpy(uv)).numpy(), want)


@pytest.mark.parametrize("sign", [(1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_undistort_tangential_signs(sign):
    """Which tangential product XLA:CPU fuses depends on the signs of p1 and
    p2 (camera._tangential); each of the four cases, on random lenses."""
    r = np.random.default_rng(sum(sign) + 2 * sign[0] + 10)
    lens = dict(fx=r.uniform(300, 700), fy=r.uniform(300, 700), cx=r.uniform(280, 360),
                cy=r.uniform(200, 280), k1=r.uniform(-0.4, 0.4), k2=r.uniform(-1, 1),
                k3=r.uniform(-1, 1.2), p1=sign[0] * r.uniform(1e-4, 6e-3),
                p2=sign[1] * r.uniform(1e-4, 6e-3), width=640, height=480)
    jcam, cam = jcamera.Camera.create(**lens), camera.Camera.create(**lens)
    uv = np.random.default_rng(8).uniform([0, 0], [640, 480], (50_000, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jcam.undistort_points(x))(jnp.asarray(uv)))
    np.testing.assert_array_equal(cam.undistort_points(torch.from_numpy(uv)).numpy(), want)


@pytest.mark.parametrize("name", DISTORTED)
def test_distort_and_project(name):
    lens = _lens(name)
    jcam, cam = jcamera.Camera.create(**lens), camera.Camera.create(**lens)
    rng = np.random.default_rng(9)
    X = np.stack([rng.uniform(-0.3, 0.3, 400), rng.uniform(-0.25, 0.25, 400),
                  rng.uniform(0.5, 4.0, 400)], 1).astype(np.float32)
    X[0] = [0.1, 0.1, 0.0]   # z = 0 takes the 1e-9 guard
    xn = X[1:, :2] / X[1:, 2:]
    np.testing.assert_array_equal(cam.distort_normalized(torch.from_numpy(xn)).numpy(),
                                  np.asarray(jcam.distort_normalized(jnp.asarray(xn))))
    for distort in (False, True):
        np.testing.assert_array_equal(cam.project(torch.from_numpy(X), distort=distort).numpy(),
                                      np.asarray(jcam.project(jnp.asarray(X), distort=distort)))
    # the undistortion inverts the distortion in the stable centre of the image
    uv = cam.project(torch.from_numpy(X[1:]), distort=True)
    np.testing.assert_allclose(cam.undistort_points(uv).numpy(),
                               cam.project(torch.from_numpy(X[1:])).numpy(), atol=0.05)


@pytest.mark.parametrize("name", DISTORTED + ["tum_fr3"])
def test_image_bounds(name):
    lens = _lens(name)
    cam = camera.Camera.create(**lens)
    b = cam.image_bounds()
    np.testing.assert_array_equal(b, camera.undistorted_bounds(*(getattr(cam, f) for f in FIELDS)))
    np.testing.assert_array_equal(b, np.asarray(jcamera.Camera.create(**lens).image_bounds()))
    # from the config's unrounded (float64) fields, as in JAX
    np.testing.assert_array_equal(camera.bounds_from_config(presets.preset(name).camera),
                                  jcamera.bounds_from_config(jpresets.preset(name).camera))
    if name == "tum_fr3":
        np.testing.assert_array_equal(b, [0, lens["width"], 0, lens["height"]])
    else:
        assert not np.array_equal(b, [0, lens["width"], 0, lens["height"]])


def test_in_image_with_margin():
    cam = camera.Camera.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
    jcam = jcamera.Camera.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
    uv = np.array([[0, 0], [640.5, 100], [-1, 5], [320, 240], [8, 8], [7.9, 300], [631.9, 471.9],
                   [632, 200]], np.float32)
    for margin in (0.0, 8.0):
        got = cam.in_image(torch.from_numpy(uv), margin)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcam.in_image(jnp.asarray(uv), margin)))
    np.testing.assert_array_equal(cam.in_image(torch.from_numpy(uv)).numpy(),
                                  [True, False, False, True, True, True, True, True])


def test_pixel4_camera():
    cam, jcam = camera.pixel4_camera(), jcamera.pixel4_camera()
    for f in FIELDS:
        assert getattr(cam, f) == float(getattr(jcam, f)), f
    assert cam == camera.Camera.create(**_lens("pixel4"))
    np.testing.assert_array_equal(np.asarray(jpresets.preset("pixel4").camera.k1, np.float32),
                                  np.float32(cam.k1))
