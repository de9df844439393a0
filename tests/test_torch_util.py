"""The port's tensor idioms (weiner_slamit_v2_torch/util.py) against the JAX
operations they stand in for, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch import util

torch.set_num_threads(1)


@pytest.mark.parametrize("op", ["set", "add", "min", "max"])
def test_put_matches_jax_drop_mode(op):
    """x.at[idx].<op>(v, mode="drop"): out-of-range indices drop, on 1-D
    and 2-D targets (unique indices for "set", whose duplicate order is
    unspecified in both frameworks)."""
    rng = np.random.default_rng(1)
    base = rng.integers(-50, 50, (12, 5)).astype(np.int32)
    n = 40 if op != "set" else 12
    rows = rng.integers(-3, 15, n) if op != "set" else rng.permutation(np.r_[0:10, 12, 13])
    cols = rng.integers(0, 6, n)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    jref = getattr(jnp.asarray(base).at[rows, cols], op)(vals, mode="drop")
    port = util.put(torch.from_numpy(base), (torch.from_numpy(rows), torch.from_numpy(cols)),
                    torch.from_numpy(vals), op)
    # JAX wraps negative indices like Python; the port's call sites never
    # pass them, so compare on rows where the two conventions agree
    keep = np.ones(12, bool)
    keep[np.unique(rows[rows < 0] % 12)] = False
    np.testing.assert_array_equal(port.numpy()[keep], np.asarray(jref)[keep])
    row1 = getattr(jnp.asarray(base[0]).at[cols], op)(vals, mode="drop")
    np.testing.assert_array_equal(
        util.put(torch.from_numpy(base[0]), torch.from_numpy(cols), torch.from_numpy(vals), op).numpy(),
        np.asarray(row1))


def test_topk_ties_go_to_lower_index():
    x = np.array([3, 7, 7, 1, 7, 3, 0, 7], np.int32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = util.topk(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scores = np.random.default_rng(0).integers(0, 4, (6, 30)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 5)
    tv, ti = util.topk(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n_nan", [0, 3, 8])
def test_nanmedian_matches_jax(n_nan):
    x = np.random.default_rng(n_nan).normal(size=8).astype(np.float32)
    x[:n_nan] = np.nan
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = util.nanmedian(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)


def test_fma_rounds_once():
    a = b = np.float32(1.0 + 2.0**-12)
    c = np.float32(-(1.0 + 2.0**-11))
    # a*b = 1 + 2^-11 + 2^-24: rounding the product first loses the 2^-24
    assert np.float32(a * b) + c == 0.0
    assert float(util.fma(torch.tensor(a), torch.tensor(b), torch.tensor(c))) == 2.0**-24


def test_resolve_device():
    """None means the card; anything else is taken as given."""
    assert util.resolve_device(None) == torch.device("cuda")
    assert util.resolve_device("cpu") == torch.device("cpu")
    assert util.resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_entry_points_default_to_the_card():
    """System, Tracker, empty_map, map_from_numpy and features_from_numpy
    build their tensors on the card when no device is given: without one they
    fail instead of falling back to the CPU."""
    from weiner_slamit_v2_torch.config import MapCapacityConfig, SlamConfig, TrackingConfig
    from weiner_slamit_v2_torch.geometry.camera import Camera
    from weiner_slamit_v2_torch.slam_map import convert, types
    from weiner_slamit_v2_torch.tracking.system import System
    from weiner_slamit_v2_torch.tracking.tracker import Tracker

    cap = MapCapacityConfig(max_keyframes=2, max_map_points=8)
    cfg = SlamConfig(capacity=cap, tracking=TrackingConfig(abortable_ba=False))
    cam = Camera.create(300.0, 300.0, 159.5, 119.5, width=320, height=240)
    arrays = convert.map_to_numpy(types.empty_map(cap, 4, device="cpu"))
    feats = {"xy": np.zeros((3, 2), np.float32), "xy_und": np.zeros((3, 2), np.float32),
             "response": np.zeros(3, np.float32), "angle": np.zeros(3, np.float32),
             "octave": np.zeros(3, np.int32), "desc": np.zeros((3, 8), np.uint32),
             "valid": np.ones(3, bool)}
    builders = [
        lambda: System(cfg, cam).tracker.m.kf_pose,
        lambda: Tracker(cfg, cam).m.kf_pose,
        lambda: types.empty_map(cap, 4).kf_pose,
        lambda: convert.map_from_numpy(arrays).kf_pose,
        lambda: convert.features_from_numpy(feats).xy,
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
                build()
    assert System(cfg, cam, device="cpu").tracker.m.kf_pose.device.type == "cpu"
