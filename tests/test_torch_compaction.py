"""The compaction trigger, the port against the JAX package: a session
whose keyframe pool fills (tests/test_tracking.py::TestCompaction) compacts
and keeps tracking as the JAX session does, and on the JAX session's state
before its first compaction the port's ``_pre_frame`` leaves what JAX's
``compact()`` left."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import H, K, W, jax_arrays, jax_system, port_system, small_config

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.slam_map.convert import map_from_numpy, map_to_numpy

torch.set_num_threads(1)


def tracker_state(t, to_np):
    """What compaction rewrites: the map's arrays, the slot counter, the
    reference keyframe, the last frame's observations, the trajectory."""
    _, Twc = t.trajectory_Twc()
    return dict(map=to_np(t.m), n_kf_host=t.n_kf_host, ref_kf=t.ref_kf,
                last_obs=np.asarray(t.last_obs), refs=[r for _, _, r in t.trajectory], Twc=Twc)


def compacting_session(sys_, seq, to_np=None):
    """Per frame (state, created_kf); the number of compact() calls; with
    ``to_np`` also the tracker state (and the JAX stacked trajectory
    relatives) just before and just after the first compaction."""
    n, first = [0], {}
    orig = sys_.compact

    def counting():
        n[0] += 1
        if to_np is not None and not first:
            sys_.finish()
            first["before"] = tracker_state(sys_.tracker, to_np)
            first["T_cr"] = np.asarray(sys_.tracker._traj_stack())
            orig()
            first["after"] = tracker_state(sys_.tracker, to_np)
        else:
            orig()

    sys_.compact = counting
    log = []
    for f in seq.frames:
        out = sys_.track_monocular(f.image, f.timestamp)
        log.append((out.state, out.created_kf))
    sys_.finish()
    return log, n[0], first


@pytest.fixture(scope="module")
def pool_runs():
    """The 12-keyframe pool session of TestCompaction (120 frames) in both
    packages: (system, log, compactions, first compaction, ATE) each."""
    seq = make_synthetic_sequence(n_frames=120, h=H, w=W, seed=7, motion="orbit", K=K)
    runs = []
    for mod, make, to_np in ((jconfig, jax_system, jax_arrays), (tconfig, port_system, None)):
        cfg = small_config(mod, max_keyframes=12, local_ba_window=6).replace(
            tracking=mod.TrackingConfig(mapping_latency_frames=1))
        sys_ = make(cfg)
        log, n, first = compacting_session(sys_, seq, to_np)
        _, Twc = sys_.tracker.trajectory_Twc()
        assert np.isfinite(Twc).all()
        runs.append((sys_, log, n, first, ate_rmse(Twc, seq.gt_Twc[-len(Twc):])))
    return seq, runs


def test_full_pool_compacts_like_jax(pool_runs):
    """Without the per-frame compaction trigger the port stopped inserting
    keyframes once the pool was full (10 created against the JAX session's
    ~40). Now: the same state sequence; both compact and keep inserting
    keyframes; finite trajectories, the scale-aligned ATE under the JAX
    test's 0.12 m and within 0.02 m. The counts are not equal: the sessions
    part at the first adopted mapping pass (point positions within 1e-3 m,
    float summation order), each keyframe decision compares inlier counts
    that then differ by a few, and the JAX session's own count of
    compactions moves with the number of CPU threads XLA uses (8 to 10 in
    38-41 keyframes). Hence the bounds: keyframes within 15 %, compactions
    within a factor 2; test_compaction_from_jax_state holds the trigger and
    the remapping exactly."""
    seq, ((js, jlog, jn, _, jate), (ts, tlog, tn, _, tate)) = pool_runs
    cap = ts.cfg.capacity.max_keyframes
    assert [s for s, _ in tlog] == [s for s, _ in jlog]
    assert sum(s == "OK" for s, _ in tlog) > 0.8 * len(seq.frames)
    j_kf, t_kf = sum(c for _, c in jlog), sum(c for _, c in tlog)
    assert t_kf > 3 * cap and abs(t_kf - j_kf) <= 0.15 * j_kf, (j_kf, t_kf)
    assert jn >= 3 and jn / 2 <= tn <= 2 * jn, (jn, tn)
    assert ts.compactions == tn
    assert max(jate, tate) < 0.12 and abs(jate - tate) < 0.02, (jate, tate)


def test_compaction_from_jax_state(pool_runs):
    """The JAX session's state just before its first compaction, loaded
    into a port System: the port's _pre_frame fires on it and leaves what
    JAX's compact() left (map arrays, slot counter, reference keyframe,
    last observations and trajectory anchors exactly; poses to 1e-6). With
    fewer than 2 reclaimable slots neither package's _pre_frame compacts."""
    _, ((js, _, _, first, _), _) = pool_runs
    before, after = first["before"], first["after"]
    sys_ = port_system(small_config(tconfig, max_keyframes=12, local_ba_window=6))
    t = sys_.tracker

    def load(state):
        t.m = map_from_numpy(state["map"], device="cpu")
        t.n_kf_host, t.ref_kf = state["n_kf_host"], state["ref_kf"]
        t.last_obs = torch.from_numpy(state["last_obs"].copy())
        t.trajectory = [(i / 30.0, torch.from_numpy(T.copy()), r)
                        for i, (T, r) in enumerate(zip(first["T_cr"], state["refs"]))]

    load(before)
    assert t.n_kf_host >= t.m.max_kf - 2 and t.n_kf_host - int(t.m.kf_valid.sum()) >= 2
    sys_._pre_frame()
    assert sys_.compactions == 1
    got = tracker_state(t, map_to_numpy)
    for k, v in after["map"].items():
        assert np.array_equal(got["map"][k], v), k
    for k in ("n_kf_host", "ref_kf", "refs"):
        assert got[k] == after[k], k
    np.testing.assert_array_equal(got["last_obs"], after["last_obs"])
    np.testing.assert_allclose(got["Twc"], after["Twc"], atol=1e-6)

    # the pool as full, but every allocated slot still valid: no compaction
    full = dict(before, map=dict(before["map"]))
    full["map"]["kf_valid"] = np.arange(t.m.max_kf) < before["n_kf_host"]
    load(full)
    sys_._pre_frame()
    jt = js.tracker
    jt.m = jt.m.replace(kf_valid=jnp.asarray(full["map"]["kf_valid"]))
    jt.n_kf_host = before["n_kf_host"]
    calls = []
    js.compact = lambda: calls.append(1)
    js._pre_frame()
    assert sys_.compactions == 1 and calls == []
