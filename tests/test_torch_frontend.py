"""The port's ORB front end against the JAX package on the same numpy inputs:
pyramid, extractor, matchers, two-view initializer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu.config import OrbConfig as JOrbConfig
from weiner_slamit_v2_tpu.frontend import initializer as jinit
from weiner_slamit_v2_tpu.frontend import matcher as jmatcher
from weiner_slamit_v2_tpu.frontend.extractor import OrbExtractor as JOrbExtractor
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.ops import pyramid as jpyramid
from weiner_slamit_v2_torch.config import OrbConfig
from weiner_slamit_v2_torch.frontend import initializer, matcher
from weiner_slamit_v2_torch.frontend.extractor import OrbExtractor
from weiner_slamit_v2_torch.ops import pyramid
from weiner_slamit_v2_torch.ops.resize_forms import SHIPPED_SIZES
from weiner_slamit_v2_torch.slam_map.convert import features_from_numpy

torch.set_num_threads(1)


def frame_u8(h, w, idx=1, seed=11, motion="orbit"):
    seq = make_synthetic_sequence(n_frames=idx + 1, h=h, w=w, seed=seed, motion=motion)
    return np.clip(seq.frames[idx].image, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", SHIPPED_SIZES)
def test_pyramid_levels(hw):
    """Levels and blur against the jitted JAX pyramid, bit for bit at all 8
    levels of every image size the repo ships: each resize output sums its
    two taps in the form XLA:CPU's dot gives it (ops/resize_forms.py), with
    the weights its compiled weight loop computes (ops/pyramid.py)."""
    img = frame_u8(*hw)

    def jax_pyr(x):
        lv = jpyramid.build_pyramid(x.astype(jnp.float32), 8, 1.2)
        return lv, [jpyramid.gaussian_blur(l) for l in lv]

    jl, jb = jax.jit(jax_pyr)(jnp.asarray(img))
    tl = pyramid.build_pyramid(torch.from_numpy(img).float(), 8, 1.2)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    # the blur on identical input is bit exact (fused multiply-add chain)
    for a, lvl in zip(jb, jl):
        b = pyramid.gaussian_blur(torch.from_numpy(np.asarray(lvl))).numpy()
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("hw", SHIPPED_SIZES)
def test_extractor_exact(hw):
    """Four frames through the program the JAX tracker compiles (extraction
    and undistortion in one jit, tracking/tracker.py make_extract): keypoints,
    angles and descriptors bit for bit (the moments summed in XLA:CPU's
    order, atan2/sin/cos as ops/xla_math.py)."""
    h, w = hw
    n_features = 256 if h <= 240 else 1024
    cam = JCamera.create(500.0, 500.0, w / 2 - 0.5, h / 2 - 0.5, width=w, height=h)
    jex = JOrbExtractor(JOrbConfig(n_features=n_features), hw, use_pallas=False)

    def extract(img):
        f = jex._extract_impl(img)
        return f.replace(xy_und=cam.undistort_points(f.xy))

    extract = jax.jit(extract)
    tex = OrbExtractor(OrbConfig(n_features=n_features), hw)
    seq = make_synthetic_sequence(n_frames=4, h=h, w=w, seed=11, motion="orbit")
    for fr in seq.frames:
        img = np.clip(fr.image, 0, 255).astype(np.uint8)
        fj = extract(jnp.asarray(img))
        ft = tex(torch.from_numpy(img))
        np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
        np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
        np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
        np.testing.assert_array_equal(ft.response.numpy(), np.asarray(fj.response))
        np.testing.assert_array_equal(ft.angle.numpy(), np.asarray(fj.angle))
        np.testing.assert_array_equal(ft.desc.numpy(), np.asarray(fj.desc).view(np.int32))
        assert int(ft.valid.sum()) > 150


@pytest.fixture(scope="module")
def jax_pair():
    """Two frames' JAX features (undistorted as the tracker does)."""
    h, w = 240, 320
    seq = make_synthetic_sequence(n_frames=4, h=h, w=w, seed=3, motion="strafe")
    cam = JCamera.create(500.0, 500.0, w / 2 - 0.5, h / 2 - 0.5, width=w, height=h)
    ex = JOrbExtractor(JOrbConfig(n_features=512), (h, w), use_pallas=False)
    feats = []
    for i in (0, 3):
        f = ex(jnp.asarray(np.clip(seq.frames[i].image, 0, 255).astype(np.uint8)))
        feats.append(f.replace(xy_und=cam.undistort_points(f.xy)))
    return feats, cam


def test_search_for_initialization_exact(jax_pair):
    (f1, f2), _ = jax_pair
    ij, dj = jmatcher.search_for_initialization(f1, f2, window=100.0, nn_ratio=0.9)
    it, dt = matcher.search_for_initialization(features_from_numpy(f1, "cpu"), features_from_numpy(f2, "cpu"),
                                               window=100.0, nn_ratio=0.9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it >= 0).sum() > 100


def test_match_with_window_exact(jax_pair):
    """Octave band, ratio test and rotation histogram, per-row windows."""
    (f1, f2), _ = jax_pair
    rng = np.random.default_rng(4)
    n = f1.xy.shape[0]
    pred = np.asarray(f1.xy_und) + rng.normal(0, 2.0, (n, 2)).astype(np.float32)
    win = rng.uniform(8, 40, n).astype(np.float32)
    lo = np.clip(np.asarray(f1.octave) - 1, 0, 7).astype(np.int32)
    hi = np.clip(np.asarray(f1.octave) + 1, 0, 7).astype(np.int32)
    kw = dict(max_dist=100, nn_ratio=0.9)
    ij, dj = jmatcher.match_with_window(
        f1.desc, f2.desc, f1.valid, f2.valid, jnp.asarray(pred), f2.xy_und, jnp.asarray(win),
        octave2=f2.octave, octave_lo=jnp.asarray(lo), octave_hi=jnp.asarray(hi),
        angle1=f1.angle, angle2=f2.angle, **kw)
    t1, t2 = features_from_numpy(f1, "cpu"), features_from_numpy(f2, "cpu")
    it, dt = matcher.match_with_window(
        t1.desc, t2.desc, t1.valid, t2.valid, torch.from_numpy(pred), t2.xy_und,
        torch.from_numpy(win), octave2=t2.octave, octave_lo=torch.from_numpy(lo),
        octave_hi=torch.from_numpy(hi), angle1=t1.angle, angle2=t2.angle, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it >= 0).sum() > 20


def test_initialize_two_view_with_jax_draws(jax_pair):
    (f1, f2), cam = jax_pair
    idx, _ = jmatcher.search_for_initialization(f1, f2, window=100.0, nn_ratio=0.9)
    ok = np.asarray(idx) >= 0
    i2 = np.maximum(np.asarray(idx), 0)
    uv1, uv2 = np.asarray(f1.xy_und), np.asarray(f2.xy_und)[i2]
    oct_pair = np.maximum(np.asarray(f1.octave), np.asarray(f2.octave)[i2])
    sigma2 = (1.2 ** (2 * np.clip(oct_pair, 0, 7))).astype(np.float32)
    K = np.asarray(cam.K, np.float32)
    key = jax.random.PRNGKey(7)
    draws = jax.random.randint(key, (jinit.N_RANSAC, jinit.SAMPLE_SIZE), 0, max(int(ok.sum()), 1))
    rj = jinit.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(ok),
                                   jnp.asarray(K), key, sigma2=jnp.asarray(sigma2))
    rt = initializer.initialize_two_view(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(ok), torch.from_numpy(K),
        torch.from_numpy(np.asarray(draws)), sigma2=torch.from_numpy(sigma2))
    assert bool(rj.success) and bool(rt.success)
    assert bool(rj.used_homography) == bool(rt.used_homography)
    # not exact: the DLT and decomposition SVDs are LAPACK's in JAX and
    # torch's own here (cuSOLVER on the card), and they part by ulps on the
    # same matrix; measured on this input: Tcw2 within 1.8e-6, is_point
    # equal everywhere (tools/first_divergence_torch.py: a session's first
    # divergence)
    np.testing.assert_allclose(rt.Tcw2.numpy(), np.asarray(rj.Tcw2), atol=1e-4)
    assert (rt.is_point.numpy() == np.asarray(rj.is_point)).mean() >= 0.99
