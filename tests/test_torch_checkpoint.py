"""Map checkpoints and compaction, the port against the JAX package: npz maps
load across packages field for field, a fresh session localizes against a
loaded map, ``compact_map`` equals the JAX one on a session's map, and
``System.compact`` keeps the trajectory (the full-pool session is in
test_torch_compaction.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reloc import use_jax_draws

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.slam_map import checkpoint as jcheckpoint
from weiner_slamit_v2_tpu.slam_map.compaction import compact_map as j_compact_map
from weiner_slamit_v2_tpu.tracking.local_mapping import invalidate_keyframe as j_invalidate_keyframe
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.slam_map import checkpoint
from weiner_slamit_v2_torch.slam_map.compaction import compact_map
from weiner_slamit_v2_torch.slam_map.convert import map_from_numpy, map_to_numpy
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W = 240, 320
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)


def small_config(mod, **capacity):
    """tests/test_tracking.py's small_config (capacity fields overridable)."""
    cap = {**dict(max_keyframes=32, max_map_points=2048, max_obs_per_point=16, local_ba_window=8,
                  local_ba_points=512), **capacity}
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                k3=0, width=W, height=H),
        capacity=mod.MapCapacityConfig(**cap),
    )


def jax_system(cfg=None):
    return JSystem(cfg or small_config(jconfig), JCamera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H))


def port_system(cfg=None):
    cfg = cfg or small_config(tconfig)
    sys_ = System(cfg, Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H), device="cpu")
    use_jax_draws(sys_.tracker, cfg.seed)
    return sys_


def jax_arrays(m):
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """tests/test_rgbd_stereo.py::test_localize_against_loaded_map's flow:
    8 frames of the seed-23 orbit mapped by each package and saved."""
    seq = make_synthetic_sequence(n_frames=12, h=H, w=W, seed=23, motion="orbit", K=K)
    d = tmp_path_factory.mktemp("maps")
    out = {"seq": seq}
    for name, sys_ in (("jax", jax_system()), ("port", port_system())):
        for f in seq.frames[:8]:
            sys_.track_monocular(f.image, f.timestamp)
        path = str(d / f"{name}.npz")
        sys_.save_map(path)
        out[name] = (sys_, path)
    return out


def test_maps_load_across_packages(mapped, tmp_path):
    """A JAX-saved map loads in the port and a port-saved map loads in the
    JAX package, every field equal (descriptors as uint32 on both sides);
    extra arrays travel too."""
    js, jpath = mapped["jax"]
    m, extra = checkpoint.load_map(jpath, device="cpu")
    want = jax_arrays(js.map)
    got = map_to_numpy(m)
    assert set(got) == set(want) and extra == {}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    ts, _ = mapped["port"]
    p = tmp_path / "port.npz"
    checkpoint.save_map(str(p), ts.map, extra={"note": np.asarray([1, 2, 3])})
    jm, jextra = jcheckpoint.load_map(str(p))
    for k, v in map_to_numpy(ts.map).items():
        a = np.asarray(getattr(jm, k))
        assert a.dtype == v.dtype and np.array_equal(a, v), k
    np.testing.assert_array_equal(jextra["note"], [1, 2, 3])
    assert int(ts.map.n_kf) == ts.tracker.n_kf_host >= 4


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_localize_against_loaded_map(mapped, saved_by):
    """A fresh session loads the map (its own package's or the other's),
    restores the host mirrors, enters LOST, and in localization mode the
    next frame relocalizes with more than 20 inliers and adds no keyframe."""
    seq = mapped["seq"]
    _, path = mapped[saved_by]
    sys2 = port_system()
    sys2.load_map(path)
    t = sys2.tracker
    assert t.n_kf_host == int(np.load(path)["n_kf"]) and t.state == "LOST"
    assert t.ref_kf == int(np.flatnonzero(t.m.kf_valid.numpy())[-1]) and t.bow.ready
    sys2.activate_localization_mode()
    out = sys2.track_monocular(seq.frames[8].image, seq.frames[8].timestamp)
    assert out.state == "OK" and out.n_inliers > 20
    out = sys2.track_monocular(seq.frames[9].image, seq.frames[9].timestamp)
    assert out.state == "OK" and t.n_kf_host == int(np.load(path)["n_kf"])


def test_compact_map_matches_jax(mapped):
    """compact_map on the JAX session's map with two keyframes culled (and
    their points' observations rebuilt): every array equal, and kf_map /
    mp_map equal."""
    js, _ = mapped["jax"]
    m = js.map
    for kf in (1, 3):
        m = j_invalidate_keyframe(m, jnp.asarray(kf), rebuild=True)
    m = m.replace(mp_valid=m.mp_valid.at[jnp.arange(0, 40, 3)].set(False))
    jm, jkf, jmp = j_compact_map(m)
    tm, tkf, tmp = compact_map(map_from_numpy(jax_arrays(m), device="cpu"))
    np.testing.assert_array_equal(tkf.numpy(), np.asarray(jkf))
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmp))
    got, want = map_to_numpy(tm), jax_arrays(jm)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert int(tm.n_kf) == int(m.kf_valid.sum()) < int(m.n_kf)
    assert (np.asarray(jkf) == -1).sum() >= 2


def test_system_compact_keeps_the_trajectory(mapped):
    """System.compact on a session with culled keyframes: the exported
    trajectory is unchanged, the counters and the reference keyframe are
    renumbered, and tracking continues from the compacted map."""
    seq = mapped["seq"]
    sys_ = port_system()
    for f in seq.frames[:8]:
        sys_.track_monocular(f.image, f.timestamp)
    t = sys_.tracker
    sys_.finish()
    t.m = t.m.replace(kf_valid=t.m.kf_valid.clone().index_fill_(0, torch.tensor([1]), False))
    _, before = t.trajectory_Twc()
    n_valid = int(t.m.kf_valid.sum())
    sys_.compact()
    _, after = t.trajectory_Twc()
    np.testing.assert_allclose(after, before, atol=1e-5)
    assert t.n_kf_host == n_valid and int(t.m.n_kf) == n_valid and bool(t.m.kf_valid[t.ref_kf])
    assert all(r == -1 or bool(t.m.kf_valid[r]) for _, _, r in t.trajectory)
    for f in seq.frames[8:]:
        assert sys_.track_monocular(f.image, f.timestamp).state == "OK"
