"""The port's PoseNet head (weiner_slamit_v2_torch/models/posenet.py) against
the JAX package's, with JAX-initialized weights carried across through the
JAX package's save_params and the port's load_params (no trained weights are
in the repository), and Tracker.enable_posenet on a short CPU session."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from weiner_slamit_v2_tpu.models import posenet as jp
from weiner_slamit_v2_torch.config import CameraConfig, MapCapacityConfig, OrbConfig, SlamConfig
from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_torch.models import posenet as tp
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

# the heads of a random-weight net are ~1e-2: float32 summation order parts
# the packages by ~1e-8, so 1e-6 leaves room and still catches a wrong layer
HEAD_ATOL = 1e-6
# jax.image.resize's own float32 contraction is ~1.6e-3 from the float64
# value on a 0-255 frame; the port's is ~3e-5 from it
RESIZE_ATOL = 2e-3


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX params, the port's net loaded from JAX's save_params file)."""
    params = jp.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("posenet") / "jax.npz")
    jp.save_params(path, params)
    return params, tp.load_params(path)


def test_heads_match_jax(carried):
    """All four heads of the same seeded 257x257 input, and each keypoint's
    argmax cell."""
    params, net = carried
    x = np.random.default_rng(0).uniform(-1, 1, (1, 257, 257, 3)).astype(np.float32)
    jh = jp.PoseNet().apply(params, jnp.asarray(x))
    th = net(torch.from_numpy(x))
    for a, b, c in zip(jh, th, tp.HEADS):
        assert tuple(b.shape) == (1, 9, 9, c) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=HEAD_ATOL, rtol=0)
    cells = lambda h: np.asarray(h).reshape(-1, 17).argmax(0)  # noqa: E731
    np.testing.assert_array_equal(cells(th[0].numpy()), cells(jh[0]))


def test_estimate_single_pose_matches_jax(carried):
    params, net = carried
    img = np.random.default_rng(1).uniform(0, 255, (257, 257, 3)).astype(np.float32)
    jpos, jsc = jp.estimate_single_pose(params, jnp.asarray(img))
    tpos, tsc = tp.estimate_single_pose(net, torch.from_numpy(img))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_in", [240, 320, 480, 640])
def test_resize_weights_equal_jax(n_in):
    """jax.image.resize's "linear" weights (antialiased when shrinking), the
    same nonzero pattern and values to 2 float32 ulps of 1.0 (a weight is
    1 - x, normalized by its column's sum, which the packages reduce in
    another order: at 640 inputs one weight of 164,480 parts by 8.9e-8)."""
    want = jax_scale.compute_weight_mat(n_in, 257, 257 / n_in, 0.0,
                                        jax_scale._kernels[jax_scale.ResizeMethod.LINEAR], True)
    got = tp._resize_weights(n_in, 257, "cpu").numpy()
    np.testing.assert_array_equal(got > 0, np.asarray(want) > 0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=2 * float(np.spacing(np.float32(1.0))))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_frame_helper_matches_jax(carried, dtype):
    """person_keypoints_for_frame on a 240x320 frame: the uint8 frame enters
    the resize as unrounded float32 in both packages; positions to 1e-3 px,
    scores to 1e-5, the same keypoints over the threshold."""
    params, net = carried
    rng = np.random.default_rng(2)
    frame = (rng.integers(0, 256, (240, 320)).astype(np.uint8) if dtype == "uint8"
             else rng.uniform(0, 255, (240, 320)).astype(np.float32))
    small_j = jax.image.resize(jnp.repeat(jnp.asarray(frame)[..., None], 3, -1), (257, 257, 3), "linear")
    assert small_j.dtype == jnp.float32
    small_t = tp.resize_to_input(torch.from_numpy(frame))
    np.testing.assert_allclose(small_t.numpy(), np.asarray(small_j), atol=RESIZE_ATOL, rtol=0)
    jpos, jsc, jkeep = jp.person_keypoints_for_frame(params, jnp.asarray(frame))
    tpos, tsc, tkeep = tp.person_keypoints_for_frame(net, torch.from_numpy(frame))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_port_params_read_by_jax(tmp_path):
    """The port's save_params writes the flax layout: JAX's load_params
    validates it and decodes what the port decodes."""
    net = tp.init_params(torch.Generator().manual_seed(7))
    f = str(tmp_path / "port.npz")
    tp.save_params(f, net)
    with np.load(f) as z:
        assert len(z.files) == 38 and sum(z[k].size for k in z.files) == 348_115
        assert z["params/_DepthwiseSeparable_0/Conv_0/kernel"].shape == (3, 3, 1, 24)
    params = jp.load_params(f)
    img = np.random.default_rng(3).uniform(0, 255, (257, 257, 3)).astype(np.float32)
    jpos, _ = jp.estimate_single_pose(params, jnp.asarray(img))
    tpos, _ = tp.estimate_single_pose(net, torch.from_numpy(img))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-4, rtol=0)


def test_load_rejects_wrong_files(tmp_path):
    f = tmp_path / "bad.npz"
    np.savez(str(f), **{"params/Conv_0/kernel": np.zeros((3, 3, 3, 8))})
    with pytest.raises(ValueError):
        tp.load_params(str(f))             # one array of 38
    net = tp.init_params(torch.Generator().manual_seed(0))
    tp.save_params(str(f), net)
    with np.load(str(f)) as z:
        flat = {k: z[k] for k in z.files}
    flat["params/Conv_1/kernel"] = np.zeros((1, 1, 384, 16), np.float32)
    with pytest.raises(ValueError):
        tp.params_from_flax(flat)          # a head one channel short


def test_init_follows_flax_lecun_normal():
    """Kernels: truncated to +-2 std, std sqrt(1 / fan_in) (the 0.8796 factor
    undoes the truncation's shrink); biases zero; the generator decides."""
    net = tp.init_params(torch.Generator().manual_seed(0))
    w = net.blocks[5][1].weight            # 1x1, 192 -> 384: fan_in 192
    assert abs(float(w.std()) - (1 / 192) ** 0.5) < 0.02 * (1 / 192) ** 0.5
    bound = 2 * (1 / 192) ** 0.5 / 0.87962566
    assert float(w.abs().max()) <= bound * (1 + 1e-6)
    assert all(float(c.bias.abs().max()) == 0 for _, c in net.flax_names())
    again = tp.init_params(torch.Generator().manual_seed(0))
    other = tp.init_params(torch.Generator().manual_seed(1))
    assert torch.equal(again.stem.weight, net.stem.weight)
    assert not torch.equal(other.stem.weight, net.stem.weight)


def test_tracker_runs_the_head_every_frame():
    """enable_posenet on a CPU session: last_person is set on every frame
    (the blank one too) to the head's output on that frame."""
    H, W = 120, 160
    K = np.array([[150.0, 0, 79.5], [0, 150.0, 59.5], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=128),
        camera=CameraConfig(fx=150, fy=150, cx=79.5, cy=59.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=W, height=H),
        capacity=MapCapacityConfig(max_keyframes=8, max_map_points=512, max_obs_per_point=8,
                                   local_ba_window=4, local_ba_points=128),
    )
    sys_ = System(cfg, device="cpu")
    sys_.tracker.enable_posenet()
    seq = make_synthetic_sequence(n_frames=3, h=H, w=W, seed=11, motion="orbit", K=K)
    frames = [f.image for f in seq.frames] + [np.full((H, W), 128, np.uint8)]
    for i, img in enumerate(frames):
        sys_.track_monocular(img, i / 30.0)
        pos, scores, keep = sys_.tracker.last_person
        assert pos.shape == (17, 2) and scores.shape == (17,) and keep.dtype == torch.bool
        want = tp.person_keypoints_for_frame(sys_.tracker.posenet, torch.as_tensor(np.asarray(img)))
        for a, b in zip(sys_.tracker.last_person, want):
            assert torch.equal(a, b)
    again = tp.init_params(torch.Generator().manual_seed(cfg.seed + 99))
    assert torch.equal(sys_.tracker.posenet.stem.weight, again.stem.weight)
