"""Device constants of the tracking path (util.device_const and the Python
scalars that ``put`` and the kernels' callers fill on the device): each site
gives the same result from a fresh cache and from a warm one, and keeps its
constants and its result on the caller's device ("meta" stands in for a
second device here). The parity tests against the JAX package cover the
values. On a card (``cuda`` marker) every site runs under
``torch.cuda.set_sync_debug_mode("error")``:

    python -m pytest --noconftest -m cuda tests/test_torch_device_consts.py
"""

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch import util
from weiner_slamit_v2_torch.frontend import matcher
from weiner_slamit_v2_torch.frontend.extractor import FrameFeatures
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.ops import orb, pyramid, stereo
from weiner_slamit_v2_torch.optim.pose_opt import optimize_pose
from weiner_slamit_v2_torch.slam_map.point_stats import predict_octave

torch.set_num_threads(1)


def _feats(rng, n, dev, h=120, w=160):
    xy = torch.from_numpy(rng.uniform(20, [w - 20, h - 20], (n, 2)).astype(np.float32)).to(dev)
    return FrameFeatures(
        xy=xy, xy_und=xy, response=torch.ones(n, device=dev), angle=torch.zeros(n, device=dev),
        octave=torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev),
        desc=torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (n, 8)).astype(np.int32)).to(dev),
        valid=torch.ones(n, dtype=torch.bool, device=dev))


def _sites(dev: torch.device) -> dict:
    """name -> a call of that site on inputs already on ``dev``."""
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    img = f32(rng.uniform(0, 255, (120, 160)))
    xy, ang = f32(rng.uniform(20, 100, (64, 2))), f32(rng.uniform(-3, 3, 64))
    d1 = i32(rng.integers(-2**31, 2**31 - 1, (40, 8)))
    d2 = i32(rng.integers(-2**31, 2**31 - 1, (50, 8)))
    a1, a2 = f32(rng.uniform(0, 6, 40)), f32(rng.uniform(0, 6, 40))
    p1, p2 = f32(rng.uniform(0, 100, (40, 2))), f32(rng.uniform(0, 100, (50, 2)))
    ok = torch.from_numpy(rng.random(40) < 0.7).to(dev)
    Xn = rng.uniform([-1, -1, 3], [1, 1, 5], (60, 3))
    X = f32(Xn)
    uv = f32(Xn[:, :2] / Xn[:, 2:] * 300 + [80.5, 60.5])
    K = f32([[300.0, 0, 80], [0, 300, 60], [0, 0, 1]])
    eye, w, on60 = f32(np.eye(4)), f32(np.ones(60)), torch.ones(60, dtype=torch.bool, device=dev)
    on40, on50 = on60[:40], on60[:50]
    cam = Camera.create(300.0, 300.0, 80.0, 60.0, k1=-0.1, k2=0.01, p1=1e-3, p2=-1e-3, width=160,
                        height=120)
    fl, fr = _feats(rng, 48, dev), _feats(rng, 48, dev)
    img_i, scales = img.round(), f32([1.2**i for i in range(8)])
    zeros_i, zeros_b, idx = (torch.zeros(10, dtype=torch.int32, device=dev),
                             torch.zeros(10, dtype=torch.bool, device=dev), i32([1, 12]))
    return {
        "orb.orientations": lambda: (orb.orientations(img, xy),),
        "orb.brief_descriptors": lambda: (orb.brief_descriptors(img, xy, ang),),
        "pyramid.resize_linear": lambda: (pyramid.resize_linear(img, (100, 133)),),
        "matcher.rotation_consistency_mask": lambda: (matcher.rotation_consistency_mask(a1, a2, ok),),
        "matcher.match_with_window": lambda: matcher.match_with_window(d1, d2, on40, on50, p1, p2,
                                                                        window=30.0),
        "pose_opt.optimize_pose": lambda: optimize_pose(eye, X, uv, w, on60, K, n_rounds=2, n_iters=3),
        "camera.undistort_points": lambda: (cam.undistort_points(p2),),
        "point_stats.predict_octave": lambda: (predict_octave(X[:, 2], X[:, 2] * 1.5, 1.2, 8),),
        # integer images: the SAD is exact in any summation order
        "stereo.match_stereo": lambda: stereo.match_stereo(fl, fr, img_i, img_i, 60.0, 0.2, scales, 8),
        "util.put": lambda: (util.put(zeros_i, 3, 1, "add"), util.put(zeros_b, idx, True)),
    }


SITES = list(_sites(torch.device("meta")))


@pytest.mark.parametrize("site", SITES)
def test_site_result_unchanged_and_on_the_callers_device(site):
    call = _sites(torch.device("cpu"))[site]
    util._CONSTS.clear()
    cold, warm = call(), call()
    for a, b in zip(cold, warm):
        assert a.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = _sites(torch.device("meta"))[site]()
    assert all(t.device.type == "meta" for t in meta)
    for (_, dev), v in util._CONSTS.items():
        for t in v if isinstance(v, tuple) else (v,):
            assert t.device == dev


def test_put_fills_python_scalars_like_tensors():
    """put with Python / numpy scalar indices and values equals put with
    the same values as tensors."""
    base = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    for idx, vals in ((2, 7), (np.int64(1), np.int32(-4)), ((1, 2), 5)):
        t_idx = tuple(torch.tensor(i) for i in idx) if isinstance(idx, tuple) else torch.tensor(idx)
        for op in ("set", "add", "max"):
            torch.testing.assert_close(util.put(base, idx, vals, op),
                                       util.put(base, t_idx, torch.tensor(vals), op))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("site", SITES)
def test_site_runs_without_a_sync_on_the_card(cuda_device, site):
    """Every site on the card under set_sync_debug_mode("error"), once its
    constants are built; the result equals the CPU's."""
    call = _sites(cuda_device)[site]
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = _sites(torch.device("cpu"))[site]()
    for a, b in zip(got, want):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4)
