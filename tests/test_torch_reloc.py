"""Relocalization and auto-reset: the port against the JAX package.

The relocalization cascade on tests/test_tracking.py's TestStagedRelocalization
map, then whole sessions (the default abortable_ba=True pipeline) on a
synthetic orbit with blank frames (a covered lens, constant 128): a loss once
the map holds more than 5 keyframes relocalizes; a loss within the first 5
keyframes resets the session. The JAX package's draws (initializer RANSAC,
vocabulary seeding, PnP RANSAC) are fed to the port's hooks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.frontend.extractor import FrameFeatures as JFrameFeatures
from weiner_slamit_v2_tpu.frontend.initializer import N_RANSAC, SAMPLE_SIZE
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.optim.pnp import N_ITERS, SAMPLE
from weiner_slamit_v2_tpu.slam_map import types as jtypes
from weiner_slamit_v2_tpu.tracking import tracker as jtracker
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.slam_map.convert import features_from_numpy, map_from_numpy
from weiner_slamit_v2_torch.tracking import tracker as ttracker
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W = 240, 320
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
ATE_BOUND, ATE_GAP = 0.06, 0.02


def small_config(mod):
    """tests/test_tracking.py's small_config; abortable_ba keeps its default
    (True): the staged mapping pipeline."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                k3=0, width=W, height=H),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(frames_per_sync=1),
    )


def _np(a):
    return torch.from_numpy(np.array(a))


def pnp_draws_from(seed):
    """The JAX tracker's PnP key: PRNGKey(seed + 31 * frame_id + kf_id)."""
    def draws(frame_id, kf_id, n_valid):
        key = jax.random.PRNGKey(seed + 31 * frame_id + kf_id)
        return _np(jax.random.randint(key, (N_ITERS, SAMPLE), 0, max(int(n_valid), 1)))
    return draws


def use_jax_draws(tracker, seed):
    """Feed the JAX package's draws to a port tracker's hooks."""
    def init_draws(frame_id, n_valid):
        key = jax.random.PRNGKey(seed + frame_id)
        return _np(jax.random.randint(key, (N_RANSAC, SAMPLE_SIZE), 0, max(int(n_valid), 1)))

    def vocab_draws(key_seed, n):
        key, out = jax.random.PRNGKey(key_seed), []
        for _ in range(tracker.bow.depth):
            key, k1 = jax.random.split(key)
            out.append(_np(jax.random.uniform(k1, (n,))))
        return out

    tracker.init_draws, tracker.vocab_draws = init_draws, vocab_draws
    tracker.pnp_draws = pnp_draws_from(seed)


# --- the relocalization cascade ------------------------------------------------

def staged_reloc_setup():
    """tests/test_tracking.py::TestStagedRelocalization._setup: one keyframe
    with 96 points; the frame is slightly off it; 30 descriptors equal and 66
    differing by 64 bits (past TH_LOW=50, inside ORBdist=100)."""
    rng = np.random.default_rng(5)
    cfg = small_config(jconfig)
    N, P = cfg.orb.n_features, 96
    m = jtypes.empty_map(cfg.capacity, N)
    Km = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-1.0, 1.0, P), rng.uniform(-0.7, 0.7, P),
                  rng.uniform(2.0, 4.0, P)], 1).astype(np.float32)
    T_fr = np.asarray(jse3.exp(jnp.asarray([0.03, -0.02, 0.01, 0.004, -0.003, 0.002])), np.float32)
    uv_kf = (X / X[:, 2:3]) @ Km.T
    Pc = (X @ T_fr[:3, :3].T) + T_fr[:3, 3]
    uv_fr = (Pc / Pc[:, 2:3]) @ Km.T
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    desc_fr = desc.copy()
    flip = np.zeros(8, np.uint32)
    flip[:2] = 0xFFFFFFFF
    desc_fr[30:] ^= flip[None, :]
    dist = np.linalg.norm(X, axis=1).astype(np.float32)
    m = m.replace(
        kf_valid=m.kf_valid.at[0].set(True), kf_pose=m.kf_pose.at[0].set(jnp.eye(4)),
        kf_xy=m.kf_xy.at[0, :P].set(jnp.asarray(uv_kf[:, :2])),
        kf_desc=m.kf_desc.at[0, :P].set(jnp.asarray(desc)),
        kf_feat_valid=m.kf_feat_valid.at[0, :P].set(True),
        kf_obs=m.kf_obs.at[0, :P].set(jnp.arange(P)), mp_valid=m.mp_valid.at[:P].set(True),
        mp_pos=m.mp_pos.at[:P].set(jnp.asarray(X)), mp_desc=m.mp_desc.at[:P].set(jnp.asarray(desc)),
        mp_normal=m.mp_normal.at[:P].set(jnp.asarray(X / np.linalg.norm(X, axis=1, keepdims=True))),
        mp_min_dist=m.mp_min_dist.at[:P].set(jnp.asarray(dist / 1.2)),
        mp_max_dist=m.mp_max_dist.at[:P].set(jnp.asarray(dist * 1.2)),
        mp_obs_kf=m.mp_obs_kf.at[:P, 0].set(0), mp_obs_feat=m.mp_obs_feat.at[:P, 0].set(jnp.arange(P)),
        mp_n_obs=m.mp_n_obs.at[:P].set(1), n_kf=jnp.asarray(1), n_mp=jnp.asarray(P),
    )
    xy = np.zeros((N, 2), np.float32)
    xy[:P] = uv_fr[:, :2]
    dsc = np.zeros((N, 8), np.uint32)
    dsc[:P] = desc_fr
    feats = JFrameFeatures(xy=jnp.asarray(xy), xy_und=jnp.asarray(xy), response=jnp.zeros(N),
                           angle=jnp.zeros(N), octave=jnp.zeros(N, jnp.int32),
                           desc=jnp.asarray(dsc), valid=jnp.arange(N) < P)
    return cfg, m, feats, Km, T_fr


def to_port(m, feats):
    arrays = {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}
    fa = {f.name: np.asarray(getattr(feats, f.name)) for f in dataclasses.fields(feats)}
    return map_from_numpy(arrays, device="cpu"), features_from_numpy(fa, device="cpu")


def test_reloc_program_matches_jax():
    """BoW matching alone finds 30 matches; the wide retry must lift both
    packages past the 50-inlier gate, to the same pose (within 1e-3) near
    the true one."""
    cfg, m, feats, Km, T_fr = staged_reloc_setup()
    inv_s2 = np.asarray([1.2 ** (-2 * i) for i in range(8)], np.float32)
    sf = np.asarray([1.2**i for i in range(8)], np.float32)
    ng_j, T_j, obs_j = jtracker._reloc_program(
        m, feats, jnp.asarray([0, 0, 0]), jnp.asarray([True, False, False]),
        jnp.stack([jax.random.PRNGKey(i) for i in range(3)]), jnp.asarray(Km), jnp.asarray(inv_s2),
        jnp.asarray(sf), jnp.asarray(cfg.matcher.nn_ratio_bow), jnp.asarray(cfg.matcher.th_low),
        None, jnp.asarray(0.0), n_levels=8, histo_bins=30, accept_n=50)
    tm, tf = to_port(m, feats)
    ng_t, T_t, obs_t = ttracker._reloc_program(
        tm, tf, [0],
        lambda k, n: _np(jax.random.randint(jax.random.PRNGKey(k), (N_ITERS, SAMPLE), 0, max(n, 1))),
        torch.from_numpy(Km), torch.from_numpy(inv_s2), torch.from_numpy(sf),
        cfg.matcher.nn_ratio_bow, cfg.matcher.th_low, 8, 30, 50)
    assert int(ng_j[0]) >= 50 and ng_t[0] >= 50, (int(ng_j[0]), ng_t[0])
    np.testing.assert_allclose(T_t[0].numpy(), np.asarray(T_j[0]), atol=1e-3)
    np.testing.assert_allclose(T_t[0].numpy(), T_fr, atol=1e-2)
    # the observations equal; the pose not exactly (the pose LMs' normal
    # equations sum in another order than XLA's dots): measured within 6.0e-8
    np.testing.assert_array_equal(obs_t[0].numpy(), np.asarray(obs_j[0]))
    assert ng_t[0] == int(ng_j[0])


def test_tracker_relocalize_matches_jax():
    """Tracker._relocalize on the same map (no vocabulary yet: every
    keyframe is a candidate by descriptor matches): OK in both, the same
    inlier count and the same pose within 1e-3."""
    cfg, m, feats, Km, _ = staged_reloc_setup()
    jt = jtracker.Tracker(cfg, JCamera.create(300.0, 300.0, 160.0, 120.0, width=W, height=H))
    jt.m, jt.n_kf_host, jt.ref_kf, jt.state, jt.frame_id = m, 1, 0, jtracker.LOST, 5
    jt.K = jnp.asarray(Km)
    j_out = jt._relocalize(feats, 0.5)

    tcfg = small_config(tconfig)
    tt = ttracker.Tracker(tcfg, Camera.create(300.0, 300.0, 160.0, 120.0, width=W, height=H),
                          device="cpu")
    use_jax_draws(tt, tcfg.seed)
    tt.m, tf = to_port(m, feats)
    tt.n_kf_host, tt.ref_kf, tt.state, tt.frame_id = 1, 0, ttracker.LOST, 5
    tt.K = torch.from_numpy(Km)
    t_out = tt._relocalize(tf, 0.5)
    assert j_out.state == t_out.state == "OK"
    assert j_out.n_inliers == t_out.n_inliers and t_out.n_inliers >= 50
    np.testing.assert_allclose(t_out.Tcw.numpy(), np.asarray(j_out.Tcw), atol=1e-3)
    assert tt.last_reloc_frame == 5 and tt.velocity is None
    assert tt.last_reloc_attempt["candidates"] == [0]


# --- whole sessions --------------------------------------------------------------

def run_pair(n_frames, blank, motion_frames=None):
    """The JAX System and the port's System over one sequence whose frames
    ``blank`` are replaced by a constant 128 image."""
    seq = make_synthetic_sequence(n_frames=n_frames, h=H, w=W, seed=11, motion="orbit", K=K,
                                  motion_frames=motion_frames)
    images = [np.full_like(f.image, 128.0) if i in blank else f.image
              for i, f in enumerate(seq.frames)]

    def drive(sys_):
        states = []
        for img, f in zip(images, seq.frames):
            out = sys_.track_monocular(img, f.timestamp)
            states.append((out.state, sys_.tracker.n_kf_host))
        sys_.finish()
        return states

    js = JSystem(small_config(jconfig), JCamera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H))
    j_states = drive(js)
    tcfg = small_config(tconfig)
    ts = System(tcfg, Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H), device="cpu")
    use_jax_draws(ts.tracker, tcfg.seed)
    t_states = drive(ts)
    return seq, (js, j_states), (ts, t_states)


def ok_ate(sys_, states, gt, first=0):
    """Scale-aligned ATE over the OK frames from frame ``first`` on. Trajectory
    entry j is frame init + j (every frame after the first initialization
    logs one entry)."""
    _, Twc = sys_.tracker.trajectory_Twc()
    init = next(i for i, (s, _) in enumerate(states) if s == "OK")
    sel = [j for j in range(len(Twc)) if init + j >= first and states[init + j][0] == "OK"]
    return ate_rmse(Twc[sel], gt[init:][sel])


BLANK = (15, 16, 17)    # the map holds 6 keyframes by frame 14


@pytest.fixture(scope="module")
def reloc_sessions():
    return run_pair(30, BLANK)


def test_loss_and_relocalization_match_jax(reloc_sessions):
    """Same state sequence: LOST on the first blank frame with > 5 keyframes
    (no reset), OK again on the first frame after them, OK to the end."""
    _, (js, j_states), (ts, t_states) = reloc_sessions
    jst, tst = [s for s, _ in j_states], [s for s, _ in t_states]
    assert tst == jst, list(zip(jst, tst))
    assert tst[BLANK[0]] == "LOST" and t_states[BLANK[0]][1] > 5
    assert all(s == "LOST" for s in tst[BLANK[0]:BLANK[-1] + 1])
    assert all(s == "OK" for s in tst[BLANK[-1] + 1:])
    assert ts.tracker.last_reloc_frame == js.tracker.last_reloc_frame == BLANK[-1] + 1
    assert ts.tracker.n_kf_host == js.tracker.n_kf_host
    # the vocabulary trained at 4 keyframes, as the JAX index did
    assert ts.tracker.vocab_trainings[0][0] == 4 and js.tracker.bow.ready


def test_relocalized_trajectory_accuracy(reloc_sessions):
    seq, (js, j_states), (ts, t_states) = reloc_sessions
    ates = [ok_ate(js, j_states, seq.gt_Twc), ok_ate(ts, t_states, seq.gt_Twc)]
    assert max(ates) < ATE_BOUND and abs(ates[0] - ates[1]) < ATE_GAP, ates


def test_staged_mapping_chunk_accounting(reloc_sessions):
    """Every staged pass issued or aborted each of its 1 + 2 BA stages once
    (the JAX package's counters on the same run agree)."""
    _, (js, _), (ts, _) = reloc_sessions
    assert ts._n_ba_chunks == 2
    n_stages = 1 + ts._n_ba_chunks
    assert ts.ba_chunks_issued + ts.ba_chunks_aborted == n_stages * ts.staged_passes
    assert ts.staged_passes == ts.tracker.n_kf_host - 2 == ts.mapping_passes
    assert ts.ba_chunks_issued + ts.ba_chunks_aborted == js.ba_chunks_issued + js.ba_chunks_aborted


def test_early_loss_resets_and_reinitializes_like_jax():
    """A loss while the map holds <= 5 keyframes resets both sessions (fresh
    map and BoW index, trajectory baked to absolute poses) and both
    reinitialize on the same frame; the new session tracks OK to the end."""
    seq, (js, j_states), (ts, t_states) = run_pair(16, (3, 4), motion_frames=24)
    assert t_states == j_states, list(zip(j_states, t_states))
    st = [s for s, _ in t_states]
    first = st.index("OK")
    assert st[3] == "LOST" and t_states[3][1] == 0          # reset on the loss frame
    reinit = next(i for i in range(4, len(st)) if st[i] == "OK")
    assert all(s == "OK" for s in st[reinit:])
    assert ts.tracker.vocab_trainings == [] or ts.tracker.vocab_trainings[-1][1] > reinit
    # the first session's entries were baked to absolute poses at the reset
    assert all(ref == -1 for _, _, ref in ts.tracker.trajectory[:3 - first + 1])
    ates = [ok_ate(js, j_states, seq.gt_Twc, reinit), ok_ate(ts, t_states, seq.gt_Twc, reinit)]
    assert max(ates) < ATE_BOUND and abs(ates[0] - ates[1]) < ATE_GAP, ates


def test_localization_mode_and_system_reset(reloc_sessions):
    """Localization mode tracks without new keyframes; System.reset leaves a
    fresh session that initializes again (runs last: it changes the
    session)."""
    seq, _, (ts, _) = reloc_sessions
    n_kf = ts.tracker.n_kf_host
    ts.activate_localization_mode()
    for f in seq.frames[24:28]:
        assert ts.track_monocular(f.image, f.timestamp).state == "OK"
    assert ts.tracker.n_kf_host == n_kf and ts._stage is None and ts._pending_map is None
    ts.deactivate_localization_mode()
    assert ts.tracker.allow_keyframes
    ts.reset()
    t = ts.tracker
    assert ts.n_keyframes() == 0 and t.state == "NO_IMAGES_YET" and not t.trajectory
    assert not t.bow.ready and t.n_kf_host == 0 and t.frame_id == -1
    states = [ts.track_monocular(f.image, f.timestamp).state for f in seq.frames[:3]]
    assert "OK" in states, states
