"""Pipelined tracking (frames_per_sync > 1): the port's sync-free tracking
step and its batch loop against the JAX package's ``_track_step_impl`` and
``_build_scan_fn`` scan, on the JAX sessions' own states; the packed counter
helpers; the rollback after a loss inside a batch; whole pipelined sessions
(tests/test_tracking.py::TestPipelinedSync and the keyframe order of
tests/test_loop.py::TestLoopRecallPipelined, shortened)."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_loop import disjoint_out_and_back
from test_rgbd_stereo import synthetic_depth_for
from test_torch_slice import jax_draws

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence as j_make_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.tracking import tracker as jtracker
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.slam_map.convert import features_from_numpy, map_from_numpy
from weiner_slamit_v2_torch.tracking import tracker as ttracker
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

H, W, FX = 240, 320, 300.0
K = np.array([[FX, 0, 159.5], [0, FX, 119.5], [0, 0, 1]], np.float32)
SEQ = dict(n_frames=24, h=H, w=W, seed=11, motion="orbit", K=K)
POSE_ATOL = 1e-4     # tests/test_torch_map.py's pose tolerance
# the depth modes' pose LMs part further: one RGB-D frame's pose LM ends
# 1.8e-4 from the JAX one's (float32 sums in another order decide a step's
# acceptance), the next frame is back within 5e-6
POSE_ATOL_DEPTH = 1e-3
ATE_BOUND = 0.08     # the JAX package's pipelined bound (tests/test_tracking.py:173)
STEREO_CAM = dict(baseline_times_fx=0.2 * FX, depth_threshold=8.0)


def small_config(mod, cam=None, **tracking):
    """tests/test_tracking.py's small_config with the given TrackingConfig
    fields."""
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=256),
        camera=mod.CameraConfig(fx=FX, fy=FX, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                                width=W, height=H, **(cam or {})),
        capacity=mod.MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                                       max_obs_per_point=16, local_ba_window=8,
                                       local_ba_points=512),
        tracking=mod.TrackingConfig(**tracking),
    )


def camera(mod):
    return mod.create(FX, FX, 159.5, 119.5, width=W, height=H)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def t_(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def as_u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def run_recorded(cfg, feed, n_frames, **system):
    """A JAX System over the frames with its per-frame step calls
    (``_track_step``: args, statics, outputs) and its scan batches (mode,
    args, outputs) recorded as numpy."""
    js = JSystem(cfg, camera(JCamera), **system)
    steps, batches = [], []
    real_step = jtracker._track_step

    def step(*args, **kw):
        out = real_step(*args, **kw)
        steps.append((np_tree(args), kw, np_tree(out)))
        return out

    t = js.tracker
    real_build = t._build_scan_fn

    def build(mode="mono"):
        fn = real_build(mode)

        def scan(*args):
            out = fn(*args)
            batches.append((mode, np_tree(args), np_tree(out)))
            return out
        return scan

    t._build_scan_fn = build
    jtracker._track_step = step
    try:
        outs = [feed(js, i) for i in range(n_frames)]
        js.finish()
    finally:
        jtracker._track_step = real_step
    return js, outs, steps, tuple(batches)


@pytest.fixture(scope="module")
def jax_mono():
    """TestPipelinedSync's session: the 24-frame orbit, frames_per_sync=4,
    pipeline_warmup_kfs=4; with its trajectory, keyframe count and ATE taken
    at once (the rollback test reuses its tracker)."""
    seq = j_make_sequence(**SEQ)
    cfg = small_config(jconfig, frames_per_sync=4, pipeline_warmup_kfs=4)
    feed = lambda s, i: s.track_monocular(seq.frames[i].image, seq.frames[i].timestamp)  # noqa: E731
    js, outs, steps, batches = run_recorded(cfg, feed, len(seq.frames))
    _, Twc = js.tracker.trajectory_Twc()
    summary = dict(n_traj=len(Twc), n_kf_host=js.tracker.n_kf_host,
                   ate=ate_rmse(Twc, seq.gt_Twc[-len(Twc):]))
    return seq, js, outs, steps, batches, summary


def port_step(args, statics, cfg, **over):
    """The port's track_step on a recorded JAX ``_track_step`` call's
    inputs (``over`` replaces some of them)."""
    (m, feats, lobs, loct, lang, has_vel, vel, lT, ref_kf, Km, sf, isig, p) = args
    a = dict(lobs=lobs, lT=lT)
    a.update(over)
    return ttracker.track_step(
        map_from_numpy(fields(m), "cpu"), features_from_numpy(fields(feats), "cpu"), t_(a["lobs"]),
        t_(loct), t_(lang), t_(vel) if bool(has_vel) else None, t_(a["lT"]), int(ref_kf), t_(Km),
        t_(sf), t_(isig), cfg, float(p.local_th), t_(p.bounds))


def jax_step(args, statics, **over):
    (m, feats, lobs, loct, lang, has_vel, vel, lT, ref_kf, Km, sf, isig, p) = args
    a = dict(lobs=lobs, lT=lT)
    a.update(over)
    j = lambda x: jax.tree.map(jnp.asarray, x)  # noqa: E731
    return np_tree(jtracker._track_step(j(m), j(feats), jnp.asarray(a["lobs"]), jnp.asarray(loct),
                                        jnp.asarray(lang), jnp.asarray(has_vel), jnp.asarray(vel),
                                        jnp.asarray(a["lT"]), jnp.asarray(ref_kf), jnp.asarray(Km),
                                        jnp.asarray(sf), jnp.asarray(isig), j(p), **statics))


def assert_step_equal(got, want):
    m2, Tcw, obs, vel, T_cr, scalars, (inc_v, inc_f) = want
    assert got.scalars.tolist() == scalars.tolist()
    np.testing.assert_array_equal(got.cur_obs.numpy(), obs)
    np.testing.assert_array_equal(as_u32(got.inc[0]), inc_v)
    np.testing.assert_array_equal(as_u32(got.inc[1]), inc_f)
    np.testing.assert_array_equal(got.m.mp_visible.numpy(), m2.mp_visible)
    np.testing.assert_array_equal(got.m.mp_found.numpy(), m2.mp_found)
    for a, b in ((got.Tcw, Tcw), (got.T_cr, T_cr), (got.velocity, vel)):
        np.testing.assert_allclose(a.numpy(), b, atol=POSE_ATOL)


def test_pack_helpers_match_jax():
    """_pack_bits, _unpack_bits and _counters_at bit for bit."""
    rng = np.random.default_rng(0)
    M, B = 2048, 4
    masks = rng.random((B, M)) < 0.3
    masks[0, :33] = True        # bit 31 set: a negative int32 pattern
    jp = np.stack([np.asarray(jtracker._pack_bits(jnp.asarray(mk))) for mk in masks])
    tp = torch.stack([ttracker._pack_bits(torch.from_numpy(mk)) for mk in masks])
    np.testing.assert_array_equal(as_u32(tp), jp)
    np.testing.assert_array_equal(ttracker._unpack_bits(tp[1], M).numpy(),
                                  np.asarray(jtracker._unpack_bits(jnp.asarray(jp[1]), M)))
    snap_v, snap_f = rng.integers(0, 50, (2, M)).astype(np.int32)
    found = masks & (rng.random((B, M)) < 0.5)
    jf = np.stack([np.asarray(jtracker._pack_bits(jnp.asarray(mk))) for mk in found])
    for upto in range(B + 1):
        want = jtracker._counters_at(jnp.asarray(snap_v), jnp.asarray(snap_f), jnp.asarray(jp),
                                     jnp.asarray(jf), jnp.asarray(upto))
        got = ttracker._counters_at(torch.from_numpy(snap_v), torch.from_numpy(snap_f), tp, t_(jf),
                                    upto)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("branch", ["motion", "widened", "reference"])
def test_step_matches_jax(jax_mono, branch):
    """The port's step against the JAX package's on the last per-frame step
    of the session: as recorded (the motion-model match), with the pose
    moved so that only the 2x window finds enough matches, and with no last
    frame matches (the reference-keyframe fallback). Scalars, observations,
    counter planes and packed increments exactly; poses within 1e-4."""
    _, js, _, steps, _, _ = jax_mono
    args, statics, _ = steps[-1]
    cfg = small_config(tconfig, frames_per_sync=4, pipeline_warmup_kfs=4)
    over = {}
    if branch == "reference":
        over = dict(lobs=np.full_like(args[2], -1))
    elif branch == "widened":
        # a translation that moves the prediction past the 15 px window but
        # not past 30 px
        t_cfg, mc = cfg.tracking, cfg.matcher
        m, feats, lobs, loct, lang, has_vel, vel, lT = args[:8]
        tm, tf = map_from_numpy(fields(m), "cpu"), features_from_numpy(fields(feats), "cpu")
        for dx in (0.04, 0.06, 0.08, 0.1, 0.12, 0.15, 0.2):
            lT2 = np.array(lT)
            lT2[0, 3] += dx
            pred = t_(vel) @ t_(lT2) if bool(has_vel) else t_(lT2)
            n = [int(ttracker._track_last_frame(tm, tf, t_(lobs), t_(loct), t_(lang), pred, t_(args[9]),
                                                w, t_(args[10]), cfg.orb.n_levels, mc.nn_ratio_motion,
                                                mc.th_high, mc.histo_length)[1])
                 for w in (t_cfg.motion_search_window, 2 * t_cfg.motion_search_window)]
            if n[0] < t_cfg.min_matches_motion <= n[1]:
                over = dict(lT=lT2)
                break
        assert over, "no translation needs the widened window"
    got = port_step(args, statics, cfg, **over)
    want = jax_step(args, statics, **over)
    assert got.scalars[ttracker.S_USED_REF] == (branch == "reference")
    assert_step_equal(got, want)


def port_batch(cfg, mode, args, frame_ids):
    """A port Tracker at a recorded JAX scan's input state, with the scan's
    frames launched as one batch (``_launch_batch``)."""
    (m, xs, lobs, loct, lang, has_vel, vel, lT, ref_kf, Km, sf, isig, p) = args
    t = ttracker.Tracker(cfg, camera(Camera), device="cpu")
    t.m = map_from_numpy(fields(m), "cpu")
    t.last_obs, t.last_Tcw, t.ref_kf = t_(lobs), t_(lT), int(ref_kf)
    t.last_feats = SimpleNamespace(octave=t_(loct), angle=t_(lang))
    t.velocity = t_(vel) if bool(has_vel) else None
    t.state = ttracker.OK
    recs = [dict({k: torch.from_numpy(np.array(v[i])) for k, v in xs.items()}, ts=fid / 30.0,
                 frame_id=fid, recent_reloc=False) for i, fid in enumerate(frame_ids)]
    t._launch_batch(recs)
    return t


def assert_batch_equal(t, out, mode):
    carry, outs = out
    feats_s, Tcw_s, obs_s, T_cr_s, scalars_s, inc_s = outs[:6]
    recs = t._pending_frames
    assert len(recs) == scalars_s.shape[0]
    for i, r in enumerate(recs):
        host, j = r["scalars"]
        assert host.rows()[j] == scalars_s[i].tolist(), i
        np.testing.assert_array_equal(r["cur_obs"].numpy(), obs_s[i])
        for name in ("xy", "octave", "valid"):
            np.testing.assert_array_equal(getattr(r["feats"], name).numpy(), getattr(feats_s, name)[i])
        # the pyramid, the angles and their sine and cosine are bit-exact
        # (test_torch_frontend.py), so every BRIEF bit is
        np.testing.assert_array_equal(as_u32(r["feats"].desc), feats_s.desc[i])
        np.testing.assert_array_equal(as_u32(r["inc"][0]), inc_s[0][i])
        np.testing.assert_array_equal(as_u32(r["inc"][1]), inc_s[1][i])
        atol = POSE_ATOL if mode == "mono" else POSE_ATOL_DEPTH
        np.testing.assert_allclose(r["Tcw"].numpy(), Tcw_s[i], atol=atol)
        np.testing.assert_allclose(r["T_cr"].numpy(), T_cr_s[i], atol=atol)
        if mode != "mono":
            np.testing.assert_allclose(r["depth"].numpy(), outs[6][i], atol=1e-5)
    np.testing.assert_array_equal(t.m.mp_visible.numpy(), carry[0])
    np.testing.assert_array_equal(t.m.mp_found.numpy(), carry[1])
    np.testing.assert_array_equal(t.last_obs.numpy(), carry[2])
    np.testing.assert_allclose(t.velocity.numpy(), carry[6],
                               atol=POSE_ATOL if mode == "mono" else POSE_ATOL_DEPTH)


def test_batch_matches_jax_scan(jax_mono):
    """Every mono scan batch of the session: the port's batch loop from the
    scan's input state gives each frame's scalars, observations, keypoints
    and packed increments exactly, the poses within 1e-4, and the scan's
    carry."""
    _, js, _, _, batches, _ = jax_mono
    assert len(batches) >= 2
    cfg = small_config(tconfig, frames_per_sync=4, pipeline_warmup_kfs=4)
    for mode, args, out in batches:
        t = port_batch(cfg, mode, args, range(4))
        assert_batch_equal(t, out, mode)


def test_rollback_after_loss_matches_jax(jax_mono):
    """A batch whose third frame is blank, launched from the session's last
    scan state by both packages' trackers and resolved: LOST on that frame,
    the counter planes rolled back to it, and the same trajectory entries
    (the first two frames' poses, then the last one repeated)."""
    _, js, _, _, batches, _ = jax_mono
    mode, args, _ = batches[-1]
    (m, xs, lobs, loct, lang, has_vel, vel, lT, ref_kf, *_) = args
    imgs = np.array(xs["img"])
    imgs[2] = 128
    jt = js.tracker     # its scan program is compiled already
    jt.culled_remap.clear()
    # the map holds <= 5 keyframes: keep the auto-reset from clearing it
    jt.cfg = jt.cfg.replace(tracking=dataclasses.replace(jt.cfg.tracking, auto_reset_max_kfs=0))
    jt.m = jax.tree.map(jnp.asarray, m)
    jt.last_feats = SimpleNamespace(octave=jnp.asarray(loct), angle=jnp.asarray(lang))
    jt.last_obs, jt.last_Tcw, jt.ref_kf = jnp.asarray(lobs), jnp.asarray(lT), int(ref_kf)
    jt.velocity = jnp.asarray(vel) if bool(has_vel) else None
    jt.state, jt.n_kf_host, jt.frame_id = jtracker.OK, int(np.asarray(m.n_kf)), 100
    jt.last_kf_frame = 100
    tt = ttracker.Tracker(small_config(tconfig, frames_per_sync=4, pipeline_warmup_kfs=4,
                                       auto_reset_max_kfs=0), camera(Camera), device="cpu")
    tt.m = map_from_numpy(fields(m), "cpu")
    tt.last_feats = SimpleNamespace(octave=t_(loct), angle=t_(lang))
    tt.last_obs, tt.last_Tcw, tt.ref_kf = t_(lobs), t_(lT), int(ref_kf)
    tt.velocity = t_(vel) if bool(has_vel) else None
    tt.state, tt.n_kf_host, tt.frame_id, tt.last_kf_frame = ttracker.OK, jt.n_kf_host, 100, 100
    jt.trajectory = []
    for t in (jt, tt):
        t.allow_keyframes = False
        t.trajectory.append((0.0, t.last_Tcw, t.ref_kf))
        for i in range(4):
            img = jnp.asarray(imgs[i]) if t is jt else torch.from_numpy(imgs[i])
            t._img_buffer.append(dict(img=img, img_r=None, dmap=None, ts=(101 + i) / 30.0,
                                      frame_id=101 + i, recent_reloc=False))
        t._run_scan_batch()
        t.flush_pending()
    assert jt.state == tt.state == "LOST" and tt.loss_frames == [103]
    np.testing.assert_array_equal(tt.m.mp_visible.numpy(), np.asarray(jt.m.mp_visible))
    np.testing.assert_array_equal(tt.m.mp_found.numpy(), np.asarray(jt.m.mp_found))
    assert [r for *_, r in tt.trajectory] == [r for *_, r in jt.trajectory]
    want = np.asarray(jt._traj_stack())
    got = torch.stack([p for _, p, _ in tt.trajectory]).numpy()
    assert len(got) == 5
    np.testing.assert_allclose(got, want, atol=POSE_ATOL)
    np.testing.assert_array_equal(got[3], got[2])


@pytest.fixture(scope="module")
def port_mono(jax_mono):
    """The port's System over jax_mono's frames (the JAX initializer's draws
    fed to it)."""
    seq = jax_mono[0]
    cfg = small_config(tconfig, frames_per_sync=4, pipeline_warmup_kfs=4)
    ts = System(cfg, camera(Camera), device="cpu")
    ts.tracker.init_draws = jax_draws(cfg.seed)
    touts = [ts.track_monocular(f.image, f.timestamp) for f in seq.frames]
    ts.finish()
    return ts, touts


def test_pipelined_session_like_jax(jax_mono, port_mono):
    """TestPipelinedSync's session in both packages: deferral engages, every
    frame from initialization on has a trajectory entry, the ATE is below
    the pipelined bound. Sessions part after the first adopted mapping pass
    (ROADMAP C), so whole-session counts are held within bounds."""
    seq, js, jouts, _, _, jsum = jax_mono
    ts, touts = port_mono
    init = [o.state for o in jouts].index("OK")
    assert [o.state for o in touts].index("OK") == init
    assert all(o.state == "OK" for o in touts[init:])
    assert any(o.deferred for o in touts) and any(o.deferred for o in jouts)
    assert len(ts.tracker.trajectory) == len(seq.frames) - init == jsum["n_traj"]
    assert abs(ts.tracker.n_kf_host - jsum["n_kf_host"]) <= 2
    _, Twc = ts.tracker.trajectory_Twc()
    ates = [jsum["ate"], ate_rmse(Twc, seq.gt_Twc[-len(Twc):])]
    assert max(ates) < ATE_BOUND and abs(ates[1] - ates[0]) < 0.02, ates


def test_pipelined_loss_is_detected(port_mono):
    """TestPipelinedSync.test_pipelined_loss_is_detected on the port: noise
    frames after the session's frames are reported lost within two
    batches, and every frame is logged."""
    s, outs = port_mono
    n_logged = len(s.tracker.trajectory)
    rng = np.random.RandomState(0)
    noise = [s.track_monocular(rng.rand(H, W).astype(np.float32), 1.0 + i / 30.0).state
             for i in range(8)]
    s.finish()
    assert "OK" not in noise[-1:] and s.tracker.loss_frames[0] == len(outs), noise
    assert len(s.tracker.trajectory) == n_logged + 8


def depth_batch_case(sensor):
    """(JAX config, port config, feed) of a short depth session whose frames
    1-4 form the first scan batch (pipeline_warmup_kfs=1: depth
    initialization makes the first keyframe on frame 0)."""
    kw = dict(frames_per_sync=4, pipeline_warmup_kfs=1)
    if sensor == "rgbd":
        seq = j_make_sequence(n_frames=6, h=H, w=W, seed=21, motion="orbit", K=K, plane_depth=4.0)
        depths = synthetic_depth_for(seq)
        feed = lambda s, i: s.track_rgbd(seq.frames[i].image, depths[i], i / 30.0)  # noqa: E731
        return small_config(jconfig, **kw), small_config(tconfig, **kw), feed
    seq = j_make_sequence(n_frames=6, h=H, w=W, seed=31, motion="orbit", K=K, world="multi",
                          stereo_baseline=0.2)
    # uint8 pairs: the SAD of the stereo match is exact only on integer images
    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)  # noqa: E731
    feed = lambda s, i: s.track_stereo(u8(seq.frames[i].image), u8(seq.frames[i].image_right),  # noqa: E731
                                       i / 30.0)
    return (small_config(jconfig, STEREO_CAM, **kw).replace(sensor="stereo"),
            small_config(tconfig, STEREO_CAM, **kw).replace(sensor="stereo"), feed)


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_depth_batch_matches_jax_scan(sensor):
    """The JAX package's "rgbd" / "stereo" scan batch against the port's
    batch loop from the same state: per-feature depth within 1e-5, the rest
    as for the mono batch. The port's own session over the same frames
    batches them too and logs every frame."""
    jcfg, tcfg, feed = depth_batch_case(sensor)
    _, jouts, _, batches = run_recorded(jcfg, feed, 5, enable_mapping=False)
    mode, args, out = batches[0]
    assert mode == sensor and [o.deferred for o in jouts] == [False] + [True] * 4
    t = port_batch(tcfg, mode, args, range(1, 5))
    assert_batch_equal(t, out, mode)
    ts = System(tcfg, camera(Camera), device="cpu", enable_mapping=False)
    touts = [feed(ts, i) for i in range(5)]
    ts.finish()
    assert [o.deferred for o in touts] == [o.deferred for o in jouts]
    assert [o.state for o in touts] == ["OK"] * 5 and len(ts.tracker.trajectory) == 5


def test_pipelined_keyframes_reach_loop_closer_in_order():
    """tests/test_loop.py::TestLoopRecallPipelined, shortened: with
    frames_per_sync=4 and the staged mapping pipeline, every keyframe of a
    mapping pass reaches LoopCloser.on_keyframe once, in order, and no frame
    is lost."""
    seq = disjoint_out_and_back(n_frames=240)   # the test's pace; its first 48 frames
    cfg = tconfig.SlamConfig(
        orb=tconfig.OrbConfig(n_features=256),
        camera=tconfig.CameraConfig(fx=FX, fy=FX, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0,
                                    k3=0, width=W, height=H),
        capacity=tconfig.MapCapacityConfig(max_keyframes=96, max_map_points=8192,
                                           max_obs_per_point=16, local_ba_window=8,
                                           local_ba_points=1024),
        loop=tconfig.LoopConfig(min_kfs_between_loops=4, covisibility_consistency_th=1),
        tracking=tconfig.TrackingConfig(mapping_latency_frames=3, frames_per_sync=4,
                                        pipeline_warmup_kfs=6, reloc_min_inliers=20))
    s = System(cfg, camera(Camera), device="cpu", enable_loop_closing=True)
    lc = s.loop_closer
    seen = []
    orig = lc.on_keyframe
    lc.on_keyframe = lambda kf_id: (seen.append(kf_id), orig(kf_id))[1]
    outs = [s.track_monocular(f.image, f.timestamp) for f in seq.frames[:48]]
    s.finish()
    t = s.tracker
    assert not t.loss_frames and all(o.state == "OK" for o in outs[outs.index(
        next(o for o in outs if o.state == "OK")):])
    assert any(o.deferred for o in outs) and t.n_kf_host >= 8
    assert seen == list(range(2, t.n_kf_host)), (seen, t.n_kf_host)
