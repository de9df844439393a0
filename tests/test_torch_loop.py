"""Loop closing, the port against the JAX package stage by stage on the JAX
session's own state: the injected-drift session of
tests/test_loop.py::TestLoopClosureEndToEnd runs once in the JAX package
with every stage of its closing keyframe recorded (inputs and outputs); each
port stage takes the recorded JAX inputs. Integer outputs (candidate set,
matches, SearchBySim3, the loop matches, observation planes and validity
after each fusion, the essential graph's edges) are equal; floats within
the bounds stated at each comparison. Also: the two duplicate-index scatters
on crafted maps, the global-BA adoption of tests/test_loop.py:314-383,
compact() with loop state, and reset() with a global BA in flight."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_loop import FX, H, W, disjoint_out_and_back, loop_config

from weiner_slamit_v2_tpu.config import MapCapacityConfig as JCapacity
from weiner_slamit_v2_tpu.config import TrackingConfig as JTracking
from weiner_slamit_v2_tpu.frontend import matcher as jmatcher
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry.camera import Camera as JCamera
from weiner_slamit_v2_tpu.slam_map import types as jtypes
from weiner_slamit_v2_tpu.tracking import loop_closing as jlc
from weiner_slamit_v2_tpu.tracking.system import System as JSystem
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.bow.database import BowIndex, KeyframeDatabase
from weiner_slamit_v2_torch.frontend import matcher
from weiner_slamit_v2_torch.geometry.camera import Camera
from weiner_slamit_v2_torch.optim import pose_graph, sim3_solver
from weiner_slamit_v2_torch.slam_map.convert import map_from_numpy, map_to_numpy
from weiner_slamit_v2_torch.tracking import loop_closing as tlc
from weiner_slamit_v2_torch.tracking.system import System

torch.set_num_threads(1)

STAGES = ("_sim3_from_matches", "search_by_sim3", "_refine_sim3_on_matches", "_points_of_group",
          "_project_loop_points", "_propagate_and_fuse", "_search_and_fuse",
          "optimize_pose_graph", "correct_map_after_pose_graph")
INT_FIELDS = ("kf_obs", "mp_valid", "kf_valid", "mp_obs_kf", "mp_obs_feat", "mp_n_obs",
              "mp_found", "mp_visible")


def to_np(x):
    """JAX outputs (maps, arrays, tuples) as numpy; anything else as is."""
    if hasattr(x, "kf_pose") and dataclasses.is_dataclass(x):
        return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def t_(a):
    """numpy -> torch; uint32 descriptors as the port's int32 bit patterns."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def loop_session_config(mod):
    """tests/test_loop.py::test_detect_close_correct_improves_ate's config."""
    base = dict(orb=mod.OrbConfig(n_features=256),
                camera=mod.CameraConfig(fx=FX, fy=FX, cx=159.5, cy=119.5, k1=0, k2=0, p1=0,
                                        p2=0, k3=0, width=W, height=H),
                loop=mod.LoopConfig(min_kfs_between_loops=4, covisibility_consistency_th=1))
    return mod.SlamConfig(**base, capacity=mod.MapCapacityConfig(
        max_keyframes=64, max_map_points=6144, max_obs_per_point=16, local_ba_window=8,
        local_ba_points=1024), tracking=mod.TrackingConfig(mapping_latency_frames=1))


def inject_drift(m, xp_where, inv, apply, isin, G):
    """tests/test_loop.py:196-219: the keyframes of the first 12 frames and
    their points moved by the gauge drift G."""
    kf_sel = (m.kf_frame_id < 12) & (m.kf_frame_id >= 0) & m.kf_valid
    mp_sel = isin(m.mp_first_kf, kf_sel) & m.mp_valid
    return m.replace(kf_pose=xp_where(kf_sel[:, None, None], m.kf_pose @ inv(G)[None], m.kf_pose),
                     mp_pos=xp_where(mp_sel[:, None], apply(G, m.mp_pos), m.mp_pos))


def drift_G():
    G = np.eye(4, dtype=np.float32)
    G[:3, 3] = [0.25, 0.1, 0.15]
    c, s = np.cos(0.1), np.sin(0.1)
    G[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return G


@pytest.fixture(scope="module")
def jax_closure():
    """The JAX session up to its first loop closure (the JAX test's frames
    and per-frame finish()), with the closing keyframe's stages recorded:
    the detection (map, BoW rows, consistency groups, candidate mask,
    result) and every stage call inside the _close that returned True."""
    seq = disjoint_out_and_back()
    cfg = loop_config().replace(
        capacity=JCapacity(max_keyframes=64, max_map_points=6144, max_obs_per_point=16,
                           local_ba_window=8, local_ba_points=1024),
        tracking=JTracking(mapping_latency_frames=1))
    sys_ = JSystem(cfg, JCamera.create(FX, FX, 159.5, 119.5, width=W, height=H),
                   enable_loop_closing=True)
    t, lc = sys_.tracker, sys_.loop_closer
    # the session ends at the first closure: its global BA is never needed
    lc.run_global_ba = False
    rec = {"on": False, "calls": {}, "detect": {}, "closes": []}

    def wrap(name, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            if rec["on"]:
                rec["calls"][name] = (to_np(a), to_np(k), to_np(out))
            return out
        return run

    originals = {n: getattr(jlc, n) for n in STAGES}
    orig_match = jmatcher.match_by_descriptor
    for n in STAGES:
        setattr(jlc, n, wrap(n, originals[n]))
    jmatcher.match_by_descriptor = wrap("match_by_descriptor", orig_match)
    detect, close = lc._detect, lc._close

    def detect_rec(kf_id):
        bow = t.bow
        state = dict(m=to_np(t.m), bow=np.asarray(bow.db.bow), has=np.asarray(bow.db.has_entry),
                     counts=dict(lc.consistency_counts))
        orig_cands = bow.candidates
        bow.candidates = lambda *a, **k: state.setdefault("keep", to_np(orig_cands(*a, **k)))
        try:
            out = detect(kf_id)
        finally:
            del bow.candidates
        rec["detect"][kf_id] = dict(state, out=out, counts_after=dict(lc.consistency_counts))
        return out

    def close_rec(kf_id, cand):
        before = to_np(t.m)
        rec["on"], rec["calls"] = True, {}
        try:
            ok = close(kf_id, cand)
        finally:
            rec["on"] = False
        if ok:
            rec["closes"].append(dict(kf=kf_id, cand=cand, before=before, after=to_np(t.m),
                                      calls=rec["calls"], loop_edges=list(lc.loop_edges)))
        return ok

    lc._detect, lc._close = detect_rec, close_rec
    try:
        for i, f in enumerate(seq.frames):
            sys_.track_monocular(f.image, f.timestamp)
            if i == 36:
                sys_.finish()
                m = t.m
                t.m = inject_drift(m, jnp.where, jse3.inv, jse3.apply,
                                   lambda a, sel: jnp.isin(a, jnp.nonzero(sel)[0]),
                                   jnp.asarray(drift_G()))
            if lc.n_loops_closed:
                break
            if i > 40:
                sys_.finish()
        sys_.finish()
    finally:
        for n in STAGES:
            setattr(jlc, n, originals[n])
        jmatcher.match_by_descriptor = orig_match
    assert rec["closes"], "the JAX session closed no loop"
    first = rec["closes"][0]
    return dict(sys=sys_, cfg=cfg, first=first, detect=rec["detect"][first["kf"]])


def port_tracker(m_np):
    """A port System on the CPU (loop closing on, global BA off) whose map is
    a recorded JAX map."""
    sys_ = System(loop_session_config(tconfig), Camera.create(FX, FX, 159.5, 119.5, width=W,
                                                               height=H),
                  device="cpu", enable_loop_closing=True)
    sys_.loop_closer.run_global_ba = False
    sys_.tracker.m = map_from_numpy(m_np, device="cpu")
    return sys_


def assert_maps(got, want, atol_pose=1e-4, atol_pos=1e-4, label=""):
    """Integer fields equal; poses and positions of valid entries within the
    given bounds."""
    got = map_to_numpy(got)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")
    kv, mv = want["kf_valid"], want["mp_valid"]
    np.testing.assert_allclose(got["kf_pose"][kv], want["kf_pose"][kv], atol=atol_pose, rtol=0,
                               err_msg=f"{label} kf_pose")
    np.testing.assert_allclose(got["mp_pos"][mv], want["mp_pos"][mv], atol=atol_pos, rtol=0,
                               err_msg=f"{label} mp_pos")


def test_detection_matches_jax(jax_closure):
    """_detect on the JAX state at the closing keyframe: the same candidate
    mask, chosen candidate and consistency groups."""
    d, kf = jax_closure["detect"], jax_closure["first"]["kf"]
    sys_ = port_tracker(d["m"])
    t, lc = sys_.tracker, sys_.loop_closer
    t.bow = BowIndex(t.m.max_kf, device="cpu")
    t.bow.vocab = object()          # trained: only its rows are read here
    t.bow.db = KeyframeDatabase(bow=t_(d["bow"]), has_entry=t_(d["has"]))
    lc.consistency_counts = dict(d["counts"])
    keep = {}
    orig = t.bow.candidates
    t.bow.candidates = lambda *a, **k: keep.setdefault("keep", orig(*a, **k))
    assert lc._detect(kf) == d["out"] == jax_closure["first"]["cand"]
    np.testing.assert_array_equal(keep["keep"][1].numpy(), d["keep"][1])
    np.testing.assert_allclose(keep["keep"][0].numpy(), d["keep"][0], atol=1e-6, rtol=0)
    assert lc.consistency_counts == d["counts_after"]


def test_sim3_stages_match_jax(jax_closure):
    """BoW matching, RANSAC (JAX draws fed), SearchBySim3, refinement and
    the 40-match projection, each on the recorded JAX inputs: matches and
    inlier counts equal, S12 within 1e-4."""
    c = jax_closure["first"]
    calls, kf, cand = c["calls"], c["kf"], c["cand"]
    cfg = jax_closure["cfg"]
    sys_ = port_tracker(c["before"])
    t = sys_.tracker
    m = t.m

    a, k, (idx_j, _) = calls["match_by_descriptor"]
    idx, _ = matcher.match_by_descriptor(*map(t_, a), max_dist=k["max_dist"],
                                         nn_ratio=k["nn_ratio"], angle1=t_(k["angle1"]),
                                         angle2=t_(k["angle2"]))
    np.testing.assert_array_equal(idx.numpy(), idx_j)

    a, _, (S_j, inl_j, n_j) = calls["_sim3_from_matches"]
    pairs = tlc._matched_pairs(m, kf, cand, t_(a[3]), t.inv_sigma2, cfg.orb.n_levels)
    n_valid = max(int(pairs[2].sum()), 1)
    draws = np.asarray(jax.random.randint(a[6], (300, 3), 0, n_valid))
    np.testing.assert_array_equal(np.asarray(a[6]), np.asarray(jax.random.PRNGKey(cfg.seed + 97 * kf)))
    S12, inl, n = sim3_solver.ransac_sim3(*pairs, t.K, t_(draws))
    assert int(n) == int(n_j) >= cfg.loop.min_sim3_inliers
    np.testing.assert_array_equal(inl.numpy(), inl_j)
    np.testing.assert_allclose(S12.numpy(), S_j, atol=1e-4, rtol=0)

    a, _, idx2_j = calls["search_by_sim3"]
    idx2 = tlc.search_by_sim3(m, kf, cand, t_(a[3]), float(a[4]), t.K, t.scale_factors, t.bounds)
    np.testing.assert_array_equal(idx2.numpy(), idx2_j)

    a, k, (S_j, inl_j, n_j) = calls["_refine_sim3_on_matches"]
    pairs = tlc._matched_pairs(m, kf, cand, t_(a[3]), t.inv_sigma2, cfg.orb.n_levels)
    S12, inl, n = sim3_solver.refine_sim3(t_(a[6]), *pairs, t.K, chi2_th=a[7])
    assert int(n) == int(n_j)
    np.testing.assert_array_equal(inl.numpy(), inl_j)
    np.testing.assert_allclose(S12.numpy(), S_j, atol=1e-4, rtol=0)

    a, _, mask_j = calls["_points_of_group"]
    np.testing.assert_array_equal(tlc._points_of_group(m, t_(a[1])).numpy(), mask_j)
    a, _, matched_j = calls["_project_loop_points"]
    matched = tlc._project_loop_points(m, kf, t_(a[2]), t_(a[3]), float(a[4]), t.K,
                                       t.scale_factors, t.bounds)
    np.testing.assert_array_equal(matched.numpy(), matched_j)
    assert int((matched >= 0).sum()) >= cfg.loop.min_total_matches


def test_correction_stages_match_jax(jax_closure):
    """Propagation + loop fusion, SearchAndFuse and the essential graph on
    the recorded JAX inputs: observation planes and validity equal after
    each fusion; S_corr and point positions within 1e-4, the essential
    graph's poses within 2e-4."""
    c = jax_closure["first"]
    calls, kf = c["calls"], c["kf"]
    sys_ = port_tracker(c["before"])
    t = sys_.tracker

    a, _, (m_j, S_old_j, S_corr_j) = calls["_propagate_and_fuse"]
    m_in = map_from_numpy(a[0], device="cpu")
    m, S_old, S_corr = tlc._propagate_and_fuse(m_in, kf, t_(a[2]), t_(a[3]), t_(a[5]))
    np.testing.assert_array_equal(S_old.numpy(), S_old_j)
    np.testing.assert_allclose(S_corr.numpy(), S_corr_j, atol=1e-4, rtol=0)
    assert_maps(m, m_j, label="propagate+fuse")

    a, _, m_j = calls["_search_and_fuse"]
    m = tlc._search_and_fuse(map_from_numpy(a[0], device="cpu"), t_(a[1]), t_(a[2]), t.K,
                             t.scale_factors, t.sigma2, t.cfg)
    assert_maps(m, m_j, label="SearchAndFuse")

    a, k, S_opt_j = calls["optimize_pose_graph"]
    S_opt = pose_graph.optimize_pose_graph(*map(t_, a), **k)
    kv = a[1]
    np.testing.assert_allclose(S_opt.numpy()[kv], S_opt_j[kv], atol=2e-4, rtol=0)
    a, _, pos_j = calls["correct_map_after_pose_graph"]
    pos = pose_graph.correct_map_after_pose_graph(*map(t_, a))
    np.testing.assert_allclose(pos.numpy(), pos_j, atol=1e-4, rtol=0)


def test_whole_closure_from_jax_state(jax_closure):
    """LoopCloser._close on the JAX map before the closure, JAX draws fed:
    it closes; the essential graph gets the same edges; observation planes
    and validity equal JAX's after the correction; keyframe poses within
    5e-4 and points within 2e-3 (the Sim3 and the graph carry float32
    differences of 1e-5 into a map spanning 4 m)."""
    c = jax_closure["first"]
    kf, cand = c["kf"], c["cand"]
    cfg = jax_closure["cfg"]
    sys_ = port_tracker(c["before"])
    lc = sys_.loop_closer
    lc.sim3_draws = lambda k, n: t_(np.asarray(jax.random.randint(
        jax.random.PRNGKey(cfg.seed + 97 * k), (300, 3), 0, n)))
    seen = {}
    orig = tlc.optimize_pose_graph

    def spy(*a, **k):
        seen["edges"] = (a[3].numpy(), a[4].numpy())
        return orig(*a, **k)

    tlc.optimize_pose_graph = spy
    try:
        assert lc._close(kf, cand)
    finally:
        tlc.optimize_pose_graph = orig
    a = c["calls"]["optimize_pose_graph"][0]
    np.testing.assert_array_equal(seen["edges"][0], a[3])
    np.testing.assert_array_equal(seen["edges"][1], a[4])
    assert_maps(sys_.tracker.m, c["after"], atol_pose=5e-4, atol_pos=2e-3, label="close")
    (i, j, S), = lc.loop_edges
    assert (i, j) == (cand, kf)
    np.testing.assert_allclose(S.numpy(), np.asarray(c["loop_edges"][0][2]), atol=1e-4, rtol=0)


# -- crafted duplicate-index cases --------------------------------------------------

def crafted_map(n_kf=3, n_feat=8, n_mp=8):
    """An empty JAX map's arrays (capacities n_kf / n_mp, n_feat features)."""
    cap = JCapacity(max_keyframes=n_kf, max_map_points=n_mp, max_obs_per_point=4)
    return {k: v.copy() for k, v in to_np(jtypes.empty_map(cap, n_feat)).items()}


def jax_map(arrays):
    return jtypes.empty_map(JCapacity(max_keyframes=arrays["kf_pose"].shape[0],
                                      max_map_points=arrays["mp_pos"].shape[0],
                                      max_obs_per_point=arrays["mp_obs_kf"].shape[1]),
                            arrays["kf_obs"].shape[1]).replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})


def bits(d, n):
    """Descriptor d with its first n bits flipped."""
    out = d.copy()
    for b in range(n):
        out[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_search_by_sim3_duplicate_claim_takes_the_last_row():
    """Two points of kf2 (at features 3 and 5) project onto kf1's feature 0;
    kf1's point there matches back to feature 5. XLA:CPU keeps the last
    write of agree.at[f1].set(r2), so row 5 wins and the pair is mutual; a
    first-write scatter would keep row 3 and drop the match."""
    a = crafted_map(n_kf=2)
    D = np.arange(1, 9, dtype=np.uint32) * np.uint32(0x01010101)
    a["kf_valid"][:] = True
    a["kf_pose"][:] = np.eye(4, dtype=np.float32)
    a["mp_pos"][:3] = [[0, 0, 2], [0, 0, 2], [0.001, 0, 2]]
    a["mp_valid"][:3] = True
    a["mp_desc"][:3] = [D, bits(D, 10), bits(D, 12)]
    a["mp_min_dist"][:3], a["mp_max_dist"][:3] = 0.5, 2.0
    proj = lambda X: [FX * X[0] / X[2] + 159.5, FX * X[1] / X[2] + 119.5]  # noqa: E731
    a["kf_xy"][0, 0] = proj(a["mp_pos"][0])
    a["kf_xy"][1, 3], a["kf_xy"][1, 5] = proj(a["mp_pos"][1]), proj(a["mp_pos"][2])
    a["kf_desc"][0, 0], a["kf_desc"][1, 3], a["kf_desc"][1, 5] = D, bits(D, 20), D
    for k, f, p in ((0, 0, 0), (1, 3, 1), (1, 5, 2)):
        a["kf_feat_valid"][k, f], a["kf_obs"][k, f] = True, p
    Km = np.array([[FX, 0, 159.5], [0, FX, 119.5], [0, 0, 1]], np.float32)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    bounds = np.array([0, W, 0, H], np.float32)
    want = np.asarray(jlc.search_by_sim3(jax_map(a), jnp.asarray(0), jnp.asarray(1),
                                         jnp.eye(4), jnp.asarray(7.5), jnp.asarray(Km),
                                         jnp.asarray(sf), jnp.asarray(bounds)))
    got = tlc.search_by_sim3(map_from_numpy(a, device="cpu"), 0, 1, torch.eye(4), 7.5, t_(Km),
                             t_(sf), t_(bounds)).numpy()
    assert want[0] == 5
    np.testing.assert_array_equal(got, want)


def test_loop_fusion_duplicate_loser_takes_the_last_feature():
    """The current keyframe sees point 0 at features 1 and 4, matched to loop
    points 2 and 3: r.at[loser].set(winner) gets two updates for slot 0, and
    XLA:CPU keeps the later feature's (point 3)."""
    a = crafted_map()
    a["kf_valid"][:] = True
    a["kf_pose"][:] = np.eye(4, dtype=np.float32)
    a["mp_valid"][:4] = True
    a["mp_pos"][:4] = np.arange(12, dtype=np.float32).reshape(4, 3) + [0, 0, 3]
    a["kf_feat_valid"][:] = True
    a["kf_obs"][2, [1, 4]] = 0
    a["kf_obs"][0, [0, 1]] = [2, 3]
    a["mp_found"][:4], a["mp_visible"][:4] = [5, 1, 2, 3], [7, 1, 4, 6]
    matched = np.full(8, -1, np.int32)
    matched[[1, 4]] = [2, 3]
    group = np.array([False, False, True])
    m = jtypes.rebuild_observation_lists(jax_map(a))
    cfg = loop_config()
    K_ = jnp.asarray(np.array([[FX, 0, 159.5], [0, FX, 119.5], [0, 0, 1]], np.float32))
    sf = jnp.asarray((1.2 ** np.arange(8)).astype(np.float32))
    m_j, _, _ = jlc._propagate_and_fuse(m, jnp.asarray(2), jnp.eye(4), jnp.asarray(group),
                                        jnp.zeros(8, bool), jnp.asarray(matched), K_, sf, sf * sf,
                                        cfg)
    want = to_np(m_j)
    m_t, _, _ = tlc._propagate_and_fuse(map_from_numpy(to_np(m), device="cpu"), 2, torch.eye(4),
                                        t_(group), t_(matched))
    assert list(want["kf_obs"][2, [1, 4]]) == [3, 3]
    assert_maps(m_t, want, label="crafted fusion")


# -- the global BA's adoption, compaction and reset ---------------------------------

def test_adopt_gba_propagates_like_jax():
    """tests/test_loop.py:314-383: a keyframe created during the BA follows
    its parent; BA keyframes and points take their results; the port equals
    the JAX adoption (1e-6)."""
    cap = JCapacity(max_keyframes=8, max_map_points=64, max_obs_per_point=4)
    N = 16
    m = jtypes.empty_map(cap, n_features=N)
    mk = lambda xi: jse3.exp(jnp.asarray(xi, jnp.float32))  # noqa: E731
    feats = (jnp.zeros((N, 2)), jnp.zeros(N, jnp.int32), jnp.zeros(N), jnp.zeros((N, 8), jnp.uint32),
             jnp.ones(N, bool), jnp.full(N, -1, jnp.int32))
    poses = [mk([0, 0, 0, 0, 0, 0]), mk([0.5, 0, 0, 0, 0.1, 0]), mk([1.0, 0, 0, 0, 0.2, 0])]
    for i, T in enumerate(poses):
        m, _ = jtypes.add_keyframe(m, T, *feats, jnp.asarray(i), jnp.asarray(float(i)),
                                   jnp.asarray(i - 1))
    m, _ = jtypes.add_map_points(
        m, pos=jnp.asarray([[0.0, 0.0, 5.0]]), desc=jnp.zeros((1, 8), jnp.uint32),
        normal=jnp.asarray([[0.0, 0.0, 1.0]]), min_dist=jnp.asarray([0.1]),
        max_dist=jnp.asarray([100.0]), kf1=jnp.asarray([0], jnp.int32),
        feat1=jnp.asarray([0], jnp.int32), kf2=jnp.asarray([-1], jnp.int32),
        feat2=jnp.asarray([0], jnp.int32), valid=jnp.asarray([True]))
    child = mk([1.5, 0.1, 0, 0, 0.3, 0])
    m, _ = jtypes.add_keyframe(m, child, *feats, jnp.asarray(3), jnp.asarray(3.0), jnp.asarray(2))
    delta = mk([0.05, -0.02, 0.01, 0.02, 0.01, -0.01])
    cam_ids = jnp.asarray([0, 1, 2, -1, -1, -1, -1, -1], jnp.int32)
    ba_pose = jnp.stack([p @ jse3.inv(delta) for p in poses] + [jnp.eye(4)] * 5)
    pt_new = jse3.apply(delta, jnp.asarray([[0.0, 0.0, 5.0]]))
    point_ids = jnp.full(64, -1, jnp.int32).at[0].set(0)
    ba_pts = jnp.zeros((64, 3)).at[0].set(pt_new[0])
    args = (ba_pose, cam_ids, ba_pts, point_ids)
    want = to_np(jlc._adopt_gba(m, *args, jnp.asarray(3, jnp.int32)))
    got = map_to_numpy(tlc._adopt_gba(map_from_numpy(to_np(m), device="cpu"),
                                      *(t_(np.asarray(x)) for x in args), 3))
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["mp_pos"], want["mp_pos"], atol=1e-6, rtol=0)
    rel = got["kf_pose"][3] @ np.linalg.inv(got["kf_pose"][2])
    np.testing.assert_allclose(rel, np.asarray(child @ jse3.inv(poses[2])), atol=1e-5)


def test_compact_remaps_loop_state_like_jax(jax_closure):
    """compact() on the JAX session's final map with two keyframes culled:
    loop_edges and last_loop_kf renumbered, edges to a dropped keyframe
    gone, consistency groups cleared, as the JAX System does."""
    js = jax_closure["sys"]
    jt, jlcl = js.tracker, js.loop_closer
    kv = np.asarray(jt.m.kf_valid).copy()
    slots = np.flatnonzero(kv)
    kv[slots[[1, 3]]] = False
    edges = [(int(slots[0]), int(slots[-1])), (int(slots[1]), int(slots[-2])),
             (int(slots[2]), int(slots[-3]))]
    S = np.eye(4, dtype=np.float32)
    jt.m = jt.m.replace(kf_valid=jnp.asarray(kv))
    jlcl.loop_edges = [(i, j, jnp.asarray(S)) for i, j in edges]
    jlcl.last_loop_kf = int(slots[-1])
    jlcl.consistency_counts = {int(slots[2]): 1}
    sys_ = port_tracker(to_np(jt.m))
    t, lc = sys_.tracker, sys_.loop_closer
    t.n_kf_host, t.ref_kf = jt.n_kf_host, int(slots[-1])
    lc.loop_edges = [(i, j, t_(S)) for i, j in edges]
    lc.last_loop_kf, lc.consistency_counts = jlcl.last_loop_kf, dict(jlcl.consistency_counts)
    js.compact()
    sys_.compact()
    assert [(i, j) for i, j, _ in lc.loop_edges] == [(i, j) for i, j, _ in jlcl.loop_edges]
    assert len(lc.loop_edges) == 2 and lc.last_loop_kf == jlcl.last_loop_kf
    assert lc.consistency_counts == jlcl.consistency_counts == {}
    assert t.n_kf_host == jt.n_kf_host


def test_reset_discards_a_global_ba_in_flight(jax_closure):
    """A reset drops the global BA in flight (no chunk issued after it, no
    adoption) and keeps the loop state, as the JAX package does
    (discard_pending_gba is all its reset reaches; ROADMAP C)."""
    sys_ = port_tracker(jax_closure["first"]["after"])
    t, lc = sys_.tracker, sys_.loop_closer
    t.n_kf_host = int(t.m.n_kf)
    lc.loop_edges, lc.last_loop_kf = [(0, 5, torch.eye(4))], 5
    lc.consistency_counts = {3: 1}
    lc._enqueue_global_ba(gauge_kf=0)
    assert lc._pending_gba is not None and lc.gba_chunks_issued == 1
    sys_.reset()
    assert lc._pending_gba is None
    assert not lc.poll_global_ba(force=True) and lc.gba_chunks_issued == 1
    assert (lc.last_loop_kf, lc.consistency_counts, len(lc.loop_edges)) == (5, {3: 1}, 1)
    assert t.n_kf_host == 0
