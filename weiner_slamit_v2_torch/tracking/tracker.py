"""Per-frame tracking: the front-end state machine (port of
weiner_slamit_v2_tpu/tracking/tracker.py, the per-frame path; Tracking,
src/Tracking.cc). States NOT_INITIALIZED / OK / LOST as in
include/Tracking.h:88-94.

The entry point chooses the sensor mode: ``process_frame(image, ts)`` is
monocular, ``depth=`` RGB-D (per-feature depth looked up in the depth map),
``image_right=`` stereo (a second extraction and ``ops/stereo.match_stereo``).
A depth-bearing frame initializes on its own (one keyframe, points
unprojected from depth), adds the stereo right-u rows to the pose LMs, and
creates close points from depth at each keyframe; ``cfg.sensor`` picks the
keyframe gates (ratioMap, thRefRatio 0.75, c1c) and the motion window (7 px
for stereo / RGB-D), as in the JAX package.

Every keyframe is registered in the BoW index (bow/); its vocabulary trains
online at 4 keyframes and retrains at 16 and 64. A LOST frame relocalizes
(BoW candidates -> RANSAC PnP -> pose LM -> wide and narrow projection
retries, Tracking::Relocalization); a loss while the map holds <= 5
keyframes resets the session. The random draws (initializer RANSAC,
vocabulary seeding, PnP RANSAC) come through the hooks ``init_draws``,
``vocab_draws`` and ``pnp_draws``, seeded from ``cfg.seed`` as the JAX
package seeds its keys; the tests feed the JAX package's own draws.

Not ported (it raises ``NotImplementedError``): the fused N-frame scan
(``frames_per_sync > 1``; ROADMAP A.7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..bow.database import BowIndex
from ..config import SlamConfig
from ..frontend import matcher
from ..frontend.extractor import FrameFeatures, OrbExtractor
from ..frontend.initializer import draw_samples, initialize_two_view
from ..geometry import se3, triangulate
from ..geometry.camera import Camera, bounds_from_config
from ..optim import pnp
from ..optim.local_ba import BAProblem, solve_ba
from ..optim.pose_opt import optimize_pose
from ..ops.stereo import depth_from_depthmap, match_stereo
from ..slam_map import types as mt
from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.point_stats import predict_octave, refresh_point_stats
from ..slam_map.types import SlamMap
from ..util import nanmedian, put, resolve_device, topk

NO_IMAGES_YET = "NO_IMAGES_YET"
NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"

RELOC_CANDIDATES = 3        # keyframes tried per lost frame
RELOC_POSE_OPT = (4, 10, 1e-3)   # pose LM rounds, iterations, damping in relocalization


def _track_last_frame(m: SlamMap, feats: FrameFeatures, last_obs, last_octave, last_angle,
                      Tcw_pred, K, window, scale_factors, n_levels: int, nn_ratio, th_high,
                      histo_bins: int, forward=None, backward=None):
    """SearchByProjection last -> current (ORBmatcher.cc:1332-1474) with the
    rotation-histogram filter. forward / backward (stereo, () bool tensors):
    moving forward a feature appears at a finer-or-equal level, backward at a
    coarser-or-equal one (ORBmatcher.cc:1352-1394); otherwise levels
    [l-1, l+1]. Returns (cur_obs (N,), n_matches)."""
    has = last_obs >= 0
    mp = last_obs.clamp(min=0)
    has &= m.mp_valid[mp]
    Pc = se3.apply(Tcw_pred, m.mp_pos[mp])
    z = Pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    pred = torch.stack([K[0, 0] * Pc[:, 0] / zs + K[0, 2], K[1, 1] * Pc[:, 1] / zs + K[1, 2]], 1)
    has &= z > 0
    win = window * scale_factors[last_octave.clamp(0, n_levels - 1)]
    lo = (last_octave - 1).clamp(0, n_levels - 1)
    hi = (last_octave + 1).clamp(0, n_levels - 1)
    if forward is not None:
        lo = torch.where(forward, last_octave, torch.where(backward, 0, lo))
        hi = torch.where(forward, n_levels - 1, torch.where(backward, last_octave, hi))
    idx, _ = matcher.match_with_window(
        torch.where(has[:, None], m.mp_desc[mp], 0), feats.desc, has, feats.valid,
        pred_xy=pred, xy2=feats.xy_und, window=win, max_dist=th_high, nn_ratio=nn_ratio,
        octave2=feats.octave, octave_lo=lo, octave_hi=hi, angle1=last_angle,
        angle2=feats.angle, histo_bins=histo_bins,
    )
    n = feats.n
    ok = idx >= 0
    cur = put(torch.full((n,), -1, dtype=torch.int32, device=idx.device),
              torch.where(ok, idx, n), torch.where(ok, mp, -1))
    return cur, ok.sum()


def _match_reference_kf(m: SlamMap, feats: FrameFeatures, ref_kf: int, nn_ratio, th_low,
                        histo_bins: int):
    """TrackReferenceKeyFrame's matching stage (src/Tracking.cc:977-1024)."""
    ref_has = (m.kf_obs[ref_kf] >= 0) & m.kf_feat_valid[ref_kf]
    idx, _ = matcher.match_by_descriptor(
        m.kf_desc[ref_kf], feats.desc, ref_has, feats.valid, max_dist=th_low,
        nn_ratio=nn_ratio, angle1=m.kf_angle[ref_kf], angle2=feats.angle, histo_bins=histo_bins,
    )
    n = feats.n
    ok = idx >= 0
    cur = put(torch.full((n,), -1, dtype=torch.int32, device=idx.device),
              torch.where(ok, idx, n), torch.where(ok, m.kf_obs[ref_kf], -1))
    return cur, ok.sum()


def _track_local_map(m: SlamMap, feats: FrameFeatures, cur_obs, Tcw, K, scale_factors, th,
                     n_levels: int, nn_ratio, th_high, max_local_points: int,
                     local_kf_cap: int, bounds):
    """TrackLocalMap's point harvest + projection matching
    (src/Tracking.cc:1409-1626). Returns (cur_obs, visible mask (M,))."""
    dev = m.device
    mp = cur_obs.clamp(min=0)
    has = (cur_obs >= 0) & m.mp_valid[mp]
    obs_kf = m.mp_obs_kf[mp]
    obs_ok = has[:, None] & (obs_kf >= 0)
    votes = put(torch.zeros(m.max_kf, dtype=torch.int32, device=dev),
                torch.where(obs_ok, obs_kf, m.max_kf), 1, "add")
    votes = torch.where(m.kf_valid, votes, 0)
    kvals, kidx = topk(votes, min(local_kf_cap, m.max_kf))
    local_kf = put(torch.zeros(m.max_kf, dtype=torch.bool, device=dev),
                   torch.where(kvals > 0, kidx, m.max_kf), True)
    flat = torch.where((local_kf & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    in_local = put(torch.zeros(m.max_mp, dtype=torch.bool, device=dev),
                   torch.where(flat >= 0, flat, m.max_mp), True) & m.mp_valid
    already = put(torch.zeros(m.max_mp, dtype=torch.bool, device=dev),
                  torch.where(has, mp, m.max_mp), True)
    cand = in_local & ~already

    X = m.mp_pos
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    ray = X - triangulate.camera_center(Tcw)
    dist = torch.linalg.norm(ray, dim=1)
    viewcos = (ray * m.mp_normal).sum(1) / torch.clamp(dist, min=1e-9)
    in_frustum = (cand & (z > 0) & (u >= bounds[0]) & (u < bounds[1]) & (v >= bounds[2])
                  & (v < bounds[3]) & (dist >= 0.8 * m.mp_min_dist)
                  & (dist <= 1.2 * m.mp_max_dist) & (viewcos > 0.5))
    pvals, pid = topk(torch.where(in_frustum, m.mp_n_obs, -1), min(max_local_points, m.max_mp))
    p_ok = pvals >= 0
    pred_oct = predict_octave(dist[pid], m.mp_max_dist[pid], scale_factors[1], n_levels)
    r = torch.where(viewcos[pid] > 0.998, 2.5, 4.0)   # ORBmatcher.cc:65-71
    win = r * th * scale_factors[pred_oct.clamp(0, n_levels - 1)]
    idx, _ = matcher.match_with_window(
        m.mp_desc[pid], feats.desc, p_ok, feats.valid & (cur_obs < 0),
        pred_xy=torch.stack([u[pid], v[pid]], 1), xy2=feats.xy_und, window=win,
        max_dist=th_high, nn_ratio=nn_ratio, octave2=feats.octave,
        octave_lo=(pred_oct - 1).clamp(0, n_levels - 1), octave_hi=pred_oct.clamp(0, n_levels - 1),
    )
    n = feats.n
    ok = idx >= 0
    cur_obs = put(cur_obs, torch.where(ok, idx, n), torch.where(ok, pid, -1))
    visible = put(torch.zeros(m.max_mp, dtype=torch.bool, device=dev),
                  torch.where(p_ok, pid, m.max_mp), True)
    return cur_obs, visible


def _pose_opt_on_obs(m: SlamMap, feats: FrameFeatures, cur_obs, Tcw0, K, inv_sigma2,
                     n_rounds: int, n_iters: int, lm_lambda: float, ur=None, bf: float = 0.0):
    """PoseOptimization over the frame's map-point matches
    (src/Optimizer.cc:239-451); outliers are dropped from cur_obs. ur / bf:
    the frame's stereo right-u rows."""
    mp = cur_obs.clamp(min=0)
    has = (cur_obs >= 0) & m.mp_valid[mp] & feats.valid
    w = inv_sigma2[feats.octave.clamp(0, inv_sigma2.shape[0] - 1)]
    Tcw, inl, n_inl = optimize_pose(Tcw0, m.mp_pos[mp], feats.xy_und, w, has, K,
                                    n_rounds=n_rounds, n_iters=n_iters, lambda_init=lm_lambda,
                                    ur=ur, bf=bf)
    return Tcw, torch.where(inl | ~has, cur_obs, -1), n_inl


def _reloc_widen(m: SlamMap, feats: FrameFeatures, cand: int, cur_obs, Tcw, K, scale_factors,
                 n_levels: int, window_th: float, orb_dist: int, histo_bins: int):
    """The relocalization SearchByProjection (ORBmatcher.cc:1476-1604):
    project the candidate keyframe's map points that the frame does not hold
    yet; window th * scale(predicted level), levels [pred-1, pred+1], the
    plain descriptor gate ORBdist (no ratio test), rotation histogram.
    Returns cur_obs with the new matches added."""
    obs_kf = m.kf_obs[cand]
    mp = obs_kf.clamp(min=0)
    has = (obs_kf >= 0) & m.kf_feat_valid[cand] & m.mp_valid[mp]
    already = put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device),
                  torch.where(cur_obs >= 0, cur_obs.clamp(min=0), m.max_mp), True)
    has &= ~already[mp]
    X = m.mp_pos[mp]
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    pred = torch.stack([K[0, 0] * Pc[:, 0] / zs + K[0, 2], K[1, 1] * Pc[:, 1] / zs + K[1, 2]], 1)
    has &= z > 0
    dist3 = torch.linalg.norm(X - triangulate.camera_center(Tcw), dim=1)
    pred_oct = predict_octave(dist3, m.mp_max_dist[mp], scale_factors[1], n_levels)
    idx, _ = matcher.match_with_window(
        torch.where(has[:, None], m.mp_desc[mp], 0), feats.desc, has, feats.valid & (cur_obs < 0),
        pred_xy=pred, xy2=feats.xy_und,
        window=window_th * scale_factors[pred_oct.clamp(0, n_levels - 1)], max_dist=orb_dist,
        nn_ratio=1e6,   # best-only acceptance (ORBmatcher.cc:1560-1575)
        octave2=feats.octave, octave_lo=(pred_oct - 1).clamp(0, n_levels - 1),
        octave_hi=(pred_oct + 1).clamp(0, n_levels - 1), angle1=m.kf_angle[cand],
        angle2=feats.angle, histo_bins=histo_bins,
    )
    ok = idx >= 0
    return put(cur_obs, torch.where(ok, idx, feats.n), torch.where(ok, mp, -1))


def _reloc_program(m: SlamMap, feats: FrameFeatures, cands, draws, K, inv_sigma2,
                   scale_factors, nn_ratio_bow: float, th_low: int, n_levels: int,
                   histo_bins: int, accept_n: int, min_bow_matches: int = 15, ur=None,
                   bf: float = 0.0):
    """The per-candidate relocalization cascade (Tracking::Relocalization,
    src/Tracking.cc:1687-1816): descriptor matching against the keyframe ->
    RANSAC PnP -> pose LM -> if nGood < 50 a wide projection retry (th=10,
    ORBdist=100) -> if 30 < nGood < 50 a narrow one (th=3, ORBdist=64).
    draws(kf_id, n_valid) gives each candidate's PnP draws; ur / bf add the
    frame's stereo rows to the pose LMs. A candidate that
    fails the match or PnP gate scores 0 and stops there (the JAX package
    computes its rest and discards it). Returns (n_good [C] ints, Tcw [C]
    (4,4), cur_obs [C] (N,)) for the C candidate keyframe ids ``cands``."""
    n = feats.n
    w = inv_sigma2[feats.octave.clamp(0, n_levels - 1)]
    none = torch.full((n,), -1, dtype=torch.int32, device=m.device)

    def pose_opt(obs, Tcw):
        return _pose_opt_on_obs(m, feats, obs, Tcw, K, inv_sigma2, *RELOC_POSE_OPT, ur=ur, bf=bf)

    def widen(obs, Tcw, cand, th, orb_dist):
        return pose_opt(_reloc_widen(m, feats, cand, obs, Tcw, K, scale_factors, n_levels, th,
                                     orb_dist, histo_bins), Tcw)

    def one(cand):
        kf_obs = m.kf_obs[cand]
        idx, _ = matcher.match_by_descriptor(
            m.kf_desc[cand], feats.desc, (kf_obs >= 0) & m.kf_feat_valid[cand], feats.valid,
            max_dist=th_low, nn_ratio=nn_ratio_bow, angle1=m.kf_angle[cand], angle2=feats.angle,
            histo_bins=histo_bins)
        okm = idx >= 0
        if int(okm.sum()) < min_bow_matches:
            return 0, eye, none
        cur = put(none, torch.where(okm, idx, n), torch.where(okm, kf_obs, -1))
        has = (cur >= 0) & m.mp_valid[cur.clamp(min=0)]
        Tcw, inl, n_inl = pnp.ransac_pnp(m.mp_pos[cur.clamp(min=0)], feats.xy_und, has, w, K,
                                         draws(cand, int(has.sum())))
        if int(n_inl) < 10:
            return 0, eye, none
        Tcw, obs, n_good = pose_opt(torch.where(inl, cur, -1), Tcw)
        if 10 <= int(n_good) < accept_n:               # wide retry (Tracking.cc:1765-1785)
            Tcw, obs, n_good = widen(obs, Tcw, cand, 10.0, 100)
            if 30 < int(n_good) < accept_n:            # narrow retry (Tracking.cc:1787-1808)
                Tcw, obs, n_good = widen(obs, Tcw, cand, 3.0, 64)
        return int(n_good), Tcw, obs

    eye = torch.eye(4, device=m.device)
    return tuple(list(col) for col in zip(*[one(c) for c in cands]))


def _update_point_counters(m: SlamMap, visible, cur_obs) -> SlamMap:
    """IncreaseVisible / IncreaseFound (Tracking.cc:1409-1447)."""
    found = put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device),
                torch.where(cur_obs >= 0, cur_obs.clamp(min=0), m.max_mp), True)
    return m.replace(mp_visible=m.mp_visible + (visible | found).to(torch.int32),
                     mp_found=m.mp_found + found.to(torch.int32))


@dataclass
class StepResult:
    m: SlamMap
    Tcw: torch.Tensor
    cur_obs: torch.Tensor
    velocity: torch.Tensor
    T_cr: torch.Tensor
    n_matches: int
    n_inl1: int
    n_inl2: int
    ok1: bool
    n_ref: int
    n_kf_valid: int
    n_close_t: int = 0    # close-depth features matched to an observed map point
    n_close_u: int = 0    # close-depth features without one


def track_step(m: SlamMap, feats: FrameFeatures, last_obs, last_octave, last_angle,
               velocity: Optional[torch.Tensor], last_Tcw, ref_kf: int, K, scale_factors,
               inv_sigma2, cfg: SlamConfig, local_th: float, bounds, ur=None, bf: float = 0.0,
               depth=None, depth_threshold: float = 0.0) -> StepResult:
    """One tracking step in the OK state (Tracking::Track,
    src/Tracking.cc:385-694): motion-model match (2x window retry) or the
    reference-keyframe fallback, pose LM, local-map match, pose LM, point
    counters and the NeedNewKeyFrame statistics. The JAX package fuses this
    into one device program with one scalar fetch; here the scalar fetch is
    the few ``int()`` reads of the decisions. ur (N,): the frame's stereo
    right-u (-1 = none), for the stereo rows of both pose LMs and the
    one-sided octave gate; depth (N,): per-feature depth, for the
    close-point counts of the stereo keyframe gate (Tracking.cc:1238-1283)."""
    t, mc, o = cfg.tracking, cfg.matcher, cfg.optim
    n_levels, hb = cfg.orb.n_levels, mc.histo_length
    Tcw_pred = velocity @ last_Tcw if velocity is not None else last_Tcw
    # stereo/RGB-D search window th=7, mono 15 (Tracking.cc:1108)
    window = 7.0 if cfg.sensor != "monocular" else t.motion_search_window
    fwd = bwd = None
    if ur is not None and velocity is not None:
        # forward / backward motion: tz of last -> current against the
        # baseline (ORBmatcher.cc:1352-1360)
        tz = (Tcw_pred @ se3.inv(last_Tcw))[2, 3]
        base = bf / K[0, 0]
        fwd, bwd = tz > base, -tz > base

    def motion(window):
        return _track_last_frame(m, feats, last_obs, last_octave, last_angle, Tcw_pred, K,
                                 window, scale_factors, n_levels, mc.nn_ratio_motion,
                                 mc.th_high, hb, fwd, bwd)

    obs, n = motion(window)
    if int(n) < t.min_matches_motion:               # widen 2x (Tracking.cc:1108-1121)
        obs, n = motion(2.0 * window)
    need_ref = int(n) < t.min_matches_motion        # TrackReferenceKeyFrame (Tracking.cc:449)
    if need_ref:
        obs, n = _match_reference_kf(m, feats, ref_kf, mc.nn_ratio_refkf, mc.th_low, hb)
    Tcw0 = last_Tcw if need_ref else Tcw_pred
    enough = int(n) >= (t.min_matches_refkf if need_ref else t.min_matches_motion)

    Tcw1, obs, n_i1 = _pose_opt_on_obs(m, feats, obs, Tcw0, K, inv_sigma2,
                                       o.pose_opt_rounds, o.pose_opt_iters, o.lm_lambda_init, ur, bf)
    ok1 = enough and int(n_i1) >= t.min_inliers_motion
    obs, visible = _track_local_map(
        m, feats, obs, Tcw1, K, scale_factors, local_th, n_levels, mc.nn_ratio_localmap,
        mc.th_high, cfg.capacity.local_ba_points, t.local_map_kf_cap, bounds,
    )
    Tcw2, obs, n_i2 = _pose_opt_on_obs(m, feats, obs, Tcw1, K, inv_sigma2,
                                       o.pose_opt_rounds, o.pose_opt_iters, o.lm_lambda_init, ur, bf)
    # counters advance only when the pre-local-map stages succeeded
    m2 = _update_point_counters(m, visible, obs) if ok1 else m

    n_kf_valid = int(m.kf_valid.sum())
    min_obs = 3 if n_kf_valid > 2 else 2
    robs = m.kf_obs[ref_kf]
    rmp = robs.clamp(min=0)
    rhas = (robs >= 0) & m.kf_feat_valid[ref_kf] & m.mp_valid[rmp]
    n_ref = int((rhas & (m.mp_n_obs[rmp] >= min_obs)).sum())
    n_close_t = n_close_u = 0
    if depth is not None:
        # ratioMap's counts (Tracking.cc:1238-1263): close-depth features
        # matched to an observed map point, and the rest
        close = feats.valid & (depth > 0) & (depth < depth_threshold)
        mp_of = obs.clamp(min=0)
        has_map = (obs >= 0) & m.mp_valid[mp_of] & (m.mp_n_obs[mp_of] > 0)
        n_close_t, n_close_u = int((close & has_map).sum()), int((close & ~has_map).sum())
    return StepResult(
        m=m2, Tcw=Tcw2, cur_obs=obs, velocity=Tcw2 @ se3.inv(last_Tcw),
        T_cr=Tcw2 @ se3.inv(m.kf_pose[ref_kf]), n_matches=int(n), n_inl1=int(n_i1),
        n_inl2=int(n_i2), ok1=ok1, n_ref=n_ref, n_kf_valid=n_kf_valid,
        n_close_t=n_close_t, n_close_u=n_close_u,
    )


def build_initial_map(m: SlamMap, feats1: FrameFeatures, feats2: FrameFeatures, idx, good, pts,
                      Tcw2, fid1: int, ts1: float, fid2: int, ts2: float, K, inv_sigma2,
                      scale_factors, n_out: int):
    """CreateInitialMapMonocular (src/Tracking.cc:852-957): cut the 2x init
    feature budget back to the map's (matched rows first), median-depth
    rescale, two-camera init BA, freeze both keyframes, insert the points.
    Returns (map, frame-2 features cut to n_out)."""
    dev = m.device
    n_big = feats1.n

    def top_rows(f, keep):
        key = keep.float() * 1e9 + f.valid.float() * 1e6 + f.response
        return topk(key, n_out)[1]

    sel1 = top_rows(feats1, good)
    matched = put(torch.zeros(n_big, dtype=torch.bool, device=dev),
                  torch.where(good, idx.clamp(min=0), n_big), True)
    sel2 = top_rows(feats2, matched)
    f1, f2 = feats1.take(sel1), feats2.take(sel2)
    inv2 = put(torch.full((n_big,), -1, dtype=torch.int32, device=dev), sel2,
               torch.arange(n_out, dtype=torch.int32, device=dev))
    idx_n = torch.where(good[sel1], inv2[idx[sel1].clamp(min=0)], -1)
    good_n = good[sel1] & (idx_n >= 0)
    pts_n = pts[sel1]

    med = nanmedian(torch.where(good_n, pts_n[:, 2], torch.nan))   # Tracking.cc:901-930
    med = torch.where(torch.isnan(med) | (med <= 1e-6), 1.0, med)
    pts_n = pts_n / med
    Tcw2 = Tcw2.clone()
    Tcw2[:3, 3] = Tcw2[:3, 3] / med

    eye = torch.eye(4, device=dev)
    L = inv_sigma2.shape[0]
    i2 = idx_n.clamp(min=0)
    prob = BAProblem(
        cam_pose=torch.stack([eye, Tcw2]),
        cam_fixed=torch.tensor([True, False], device=dev),
        cam_valid=torch.tensor([True, True], device=dev),
        points=pts_n, point_valid=good_n,
        obs_cam=torch.where(good_n[:, None], torch.tensor([0, 1], dtype=torch.int32, device=dev), -1),
        obs_uv=torch.stack([f1.xy_und, f2.xy_und[i2]], 1),
        obs_inv_sigma2=torch.stack([inv_sigma2[f1.octave.clamp(0, L - 1)],
                                    inv_sigma2[f2.octave[i2].clamp(0, L - 1)]], 1),
        obs_valid=good_n[:, None].expand(-1, 2),
        K=K,
    )
    ba = solve_ba(prob, 5, 15)   # GlobalBundleAdjustemnt(map, 20), Tracking.cc:894
    Tcw2, pts_n = ba.cam_pose[1], ba.points
    good_n = good_n & (ba.obs_inlier | ~prob.obs_valid).all(1)

    none = torch.full((n_out,), -1, dtype=torch.int32, device=dev)
    m, kf0 = mt.add_keyframe(m, eye, f1.xy_und, f1.octave, f1.angle, f1.desc, f1.valid,
                             none, fid1, ts1, -1)
    m, kf1 = mt.add_keyframe(m, Tcw2, f2.xy_und, f2.octave, f2.angle, f2.desc, f2.valid,
                             none, fid2, ts2, kf0)
    m, _ = mt.add_map_points(
        m, pos=pts_n, desc=f1.desc,
        normal=torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n_out, 3),
        min_dist=torch.full((n_out,), 0.1, device=dev), max_dist=torch.full((n_out,), 100.0, device=dev),
        kf1=torch.full((n_out,), kf0, dtype=torch.int32, device=dev),
        feat1=torch.arange(n_out, dtype=torch.int32, device=dev),
        kf2=torch.full((n_out,), kf1, dtype=torch.int32, device=dev), feat2=i2, valid=good_n,
    )
    return refresh_point_stats(m, scale_factors), f2


def _right_u(feats: FrameFeatures, depth, bf: float):
    """Stereo right-u per feature, u - bf/z (mvuRight); -1 without depth or
    when bf is 0."""
    return torch.where((depth > 0) & (bf > 0),
                       feats.xy_und[:, 0] - bf / torch.clamp(depth, min=1e-6), -1.0)


def _depth_points(m: SlamMap, feats: FrameFeatures, depth, Tcw, camera: Camera, kf: int, create):
    """Insert the ``create`` features as map points unprojected from depth,
    observed by keyframe ``kf`` alone."""
    N, dev = feats.n, m.device
    Xw = se3.apply(se3.inv(Tcw), camera.unproject(feats.xy_und, depth))
    m, _ = mt.add_map_points(
        m, pos=Xw, desc=feats.desc,
        normal=torch.tensor([0.0, 0.0, 1.0], device=dev).expand(N, 3),
        min_dist=torch.full((N,), 0.1, device=dev), max_dist=torch.full((N,), 100.0, device=dev),
        kf1=torch.full((N,), kf, dtype=torch.int32, device=dev),
        feat1=torch.arange(N, dtype=torch.int32, device=dev),
        kf2=torch.full((N,), -1, dtype=torch.int32, device=dev),
        feat2=torch.zeros(N, dtype=torch.int32, device=dev), valid=create,
    )
    return m


def build_depth_init(m: SlamMap, feats: FrameFeatures, depth, camera: Camera, frame_id: int,
                     ts: float, scale_factors, bf: float):
    """Stereo / RGB-D initialization (Tracking::StereoInitialization,
    src/Tracking.cc:700-748): keyframe 0 at the identity, a map point for
    every feature with a depth. Returns (map, number of points)."""
    N, dev = feats.n, m.device
    eye = torch.eye(4, device=dev)
    m, kf0 = mt.add_keyframe(m, eye, feats.xy_und, feats.octave, feats.angle, feats.desc,
                             feats.valid, torch.full((N,), -1, dtype=torch.int32, device=dev),
                             frame_id, ts, -1, ur=_right_u(feats, depth, bf))
    has_d = feats.valid & (depth > 0)
    m = _depth_points(m, feats, depth, eye, camera, kf0, has_d)
    return refresh_point_stats(m, scale_factors), int(has_d.sum())


def freeze_kf_depth(m: SlamMap, Tcw, feats: FrameFeatures, cur_obs, frame_id: int, ts: float,
                    parent: int, depth, camera: Camera, depth_threshold: float, scale_factors,
                    bf: float):
    """Keyframe freeze with points from depth (Tracking::CreateNewKeyFrame,
    src/Tracking.cc:1340-1395): every untracked feature closer than the
    depth threshold becomes a point, and, walking all depth-bearing features
    closest first (tracked ones count), so does every one among the first
    100. Returns (map, kf_id)."""
    m, kf = mt.add_keyframe(m, Tcw, feats.xy_und, feats.octave, feats.angle, feats.desc,
                            feats.valid, cur_obs, frame_id, ts, parent,
                            ur=_right_u(feats, depth, bf))
    if kf < 0:
        return m, kf
    N = feats.n
    free = feats.valid & (m.kf_obs[kf] < 0) & (depth > 0)
    has_depth = feats.valid & (depth > 0)
    # a stable sort, as JAX's argsort: on a fronto-parallel plane many depths
    # tie, and the tie order decides which features rank below 100
    order = torch.argsort(torch.where(has_depth, depth, torch.inf), stable=True)
    rank = torch.empty(N, dtype=torch.int64, device=m.device).scatter_(
        0, order, torch.arange(N, device=m.device))
    m = _depth_points(m, feats, depth, Tcw, camera, kf, free & ((depth < depth_threshold) | (rank < 100)))
    return refresh_point_stats(m, scale_factors), kf


@dataclass
class TrackerOutput:
    state: str
    Tcw: Optional[torch.Tensor]
    n_inliers: int
    created_kf: bool
    # keyframe-relative pose from the tracking step (None: compose at log time)
    T_cr: Optional[torch.Tensor] = None


class Tracker:
    """Tracking session: owns the map, the BoW index and the per-frame
    state."""

    def __init__(self, cfg: SlamConfig, camera: Camera, device=None):
        if cfg.tracking.frames_per_sync != 1:
            raise NotImplementedError(
                "frames_per_sync > 1 (fused N-frame scan) is not ported: ROADMAP A.7")
        self.cfg = cfg
        self.camera = camera
        self.device = resolve_device(device)
        hw = (camera.height, camera.width)
        self.extractor = OrbExtractor(cfg.orb, hw)
        mult = cfg.orb.init_features_mult
        self.init_extractor = (
            OrbExtractor(cfg.orb.__class__(**{**cfg.orb.__dict__, "n_features": cfg.orb.n_features * mult}), hw)
            if mult > 1 else self.extractor
        )
        dev = self.device
        self.K = camera.K(dev)
        self.scale_factors = torch.from_numpy(self.extractor.scales).to(dev)
        self.sigma2 = torch.from_numpy(self.extractor.sigma2).to(dev)
        self.inv_sigma2 = torch.from_numpy(self.extractor.inv_sigma2).to(dev)
        self.bounds = torch.from_numpy(bounds_from_config(cfg.camera)).to(dev)
        self.eye4 = torch.eye(4, device=dev)
        # Camera.bf and the depth gate as float32 values, as the JAX package
        # passes them; the stereo matcher's least depth is the baseline
        # (Frame.cc:610)
        bf = np.float32(cfg.camera.baseline_times_fx)
        self.bf = float(bf)
        self.min_z = float(np.float32(bf / cfg.camera.fx if bf > 0 else 0.0))
        self.depth_threshold = float(np.float32(cfg.camera.depth_threshold))
        self.frame_id = -1
        self._clear_session()
        # per-frame log (timestamp, T_cr = Tcw Tref^-1, ref_kf), recomposed at
        # export with the reference keyframe's current pose (System.cc:401-454);
        # ref_kf -1: T_cr is an absolute pose (baked by a reset)
        self.trajectory: list[tuple[float, torch.Tensor, int]] = []
        self.mapping_hook: Optional[Callable[[int], None]] = None
        self.mapper_idle_hook: Optional[Callable[..., bool]] = None
        # called by reset(): the System drops the mapping pass in flight
        self.reset_hook: Optional[Callable[[], None]] = None
        self.allow_keyframes = True   # cleared in localization mode
        # the random draws: initializer RANSAC (frame_id, n_valid) -> (200, 8);
        # vocabulary seeding (seed, n) -> depth (n,) uniforms; PnP RANSAC
        # (frame_id, kf_id, n_valid) -> (300, 6)
        self.init_draws: Callable[[int, int], torch.Tensor] = self._default_draws
        self.vocab_draws: Callable[[int, int], list] = self._default_vocab_draws
        self.pnp_draws: Callable[[int, int, int], torch.Tensor] = self._default_pnp_draws
        # (n_kf_host, frame_id) of each vocabulary (re)training
        self.vocab_trainings: list[tuple[int, int]] = []
        # the last relocalization attempt: frame, candidates, their inliers
        self.last_reloc_attempt: Optional[dict] = None
        self.resets = 0

    def _clear_session(self) -> None:
        """A fresh map, BoW index and per-frame state (not the trajectory)."""
        self.m = mt.empty_map(self.cfg.capacity, self.cfg.orb.n_features, self.device)
        self.bow = self._make_bow()
        self.n_kf_host = 0
        self.state = NO_IMAGES_YET
        self.last_feats: Optional[FrameFeatures] = None
        self.last_obs: Optional[torch.Tensor] = None
        self.last_Tcw: Optional[torch.Tensor] = None
        self.velocity: Optional[torch.Tensor] = None
        self.ref_kf = 0
        self.last_kf_frame = 0
        self.last_reloc_frame = -(10**9)
        self.init_feats: Optional[FrameFeatures] = None
        self.init_ts = 0.0
        # the current frame's per-feature depth and stereo right-u (None:
        # monocular frame)
        self._cur_depth: Optional[torch.Tensor] = None
        self._cur_ur: Optional[torch.Tensor] = None

    def _make_bow(self) -> BowIndex:
        """A fresh recognition index: from cfg.vocabulary_path (a DBoW2 text
        vocabulary, the ORBvoc.txt flow of src/System.cc:124-129), or trained
        online from the session's keyframes."""
        cap = self.cfg.capacity.max_keyframes
        if self.cfg.vocabulary_path:
            return BowIndex.from_pretrained(self.cfg.vocabulary_path, cap,
                                            sparse_slots=self.cfg.orb.n_features, device=self.device)
        return BowIndex(cap, device=self.device)

    def _default_draws(self, frame_id: int, n_valid: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.cfg.seed + frame_id)
        return draw_samples(n_valid, g, self.device)

    def _default_vocab_draws(self, seed: int, n: int) -> list:
        g = torch.Generator().manual_seed(seed)
        return [torch.rand(n, generator=g).to(self.device) for _ in range(self.bow.depth)]

    def _default_pnp_draws(self, frame_id: int, kf_id: int, n_valid: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.cfg.seed + 31 * frame_id + kf_id)
        return pnp.draw_samples(n_valid, g, self.device)

    def _extract(self, image: torch.Tensor, initializing: bool) -> FrameFeatures:
        ex = self.init_extractor if initializing else self.extractor
        feats = ex(image)
        return feats.replace(xy_und=self.camera.undistort_points(feats.xy))

    def process_frame(self, image, timestamp: float, depth=None, image_right=None) -> TrackerOutput:
        """Track one (H, W) uint8 or float32 frame. ``depth`` (H, W) meters
        selects the RGB-D path, ``image_right`` (the rectified right view)
        the stereo path."""
        self.frame_id += 1
        upload = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)  # noqa: E731
        img = upload(image)
        initializing = self.state in (NO_IMAGES_YET, NOT_INITIALIZED)
        # the depth modes always extract with the map's feature budget
        feats = self._extract(img, initializing and depth is None and image_right is None)
        feat_depth = None
        if depth is not None:
            feat_depth = depth_from_depthmap(feats, upload(np.asarray(depth, np.float32)))
        elif image_right is not None:
            right = upload(image_right)
            feat_depth, _ = match_stereo(feats, self.extractor(right), img.to(torch.float32),
                                         right.to(torch.float32), self.bf, self.min_z,
                                         self.scale_factors, self.cfg.orb.n_levels)
        self._cur_depth = feat_depth
        self._cur_ur = None if feat_depth is None else _right_u(feats, feat_depth, self.bf)
        if initializing and feat_depth is not None:
            out = self._initialize_with_depth(feats, feat_depth, timestamp)
        elif initializing:
            out = self._try_initialize(feats, timestamp)
        elif self.state == OK:
            out = self._track(feats, timestamp)
        else:
            out = self._relocalize(feats, timestamp)
        if out.Tcw is not None:
            if out.created_kf:
                T_cr = self.eye4
            elif out.T_cr is not None:
                T_cr = out.T_cr
            else:
                T_cr = out.Tcw @ se3.inv(self.m.kf_pose[self.ref_kf])
            self.trajectory.append((timestamp, T_cr, self.ref_kf))
        elif self.trajectory:
            self.trajectory.append((timestamp, *self.trajectory[-1][1:]))
        return out

    def _initialize_with_depth(self, feats: FrameFeatures, feat_depth, ts: float) -> TrackerOutput:
        """Stereo / RGB-D initialization: one keyframe, more than 100 valid
        features required (the reference asks for 500 of 2000; scaled to the
        budget as in the JAX package)."""
        if int(feats.valid.sum()) <= 100:
            return TrackerOutput(NOT_INITIALIZED, None, 0, False)
        self.m, n_pts = build_depth_init(self.m, feats, feat_depth, self.camera, self.frame_id,
                                         ts, self.scale_factors, self.bf)
        self.n_kf_host = 1
        self.last_feats, self.last_obs = feats, self.m.kf_obs[0]
        self.last_Tcw, self.velocity = self.eye4, None
        self.ref_kf, self.last_kf_frame = 0, self.frame_id
        self.state = OK
        self._register_kf_bow(0)
        return TrackerOutput(OK, self.eye4, n_pts, True)

    def _try_initialize(self, feats: FrameFeatures, ts: float) -> TrackerOutput:
        cfg = self.cfg
        n_valid = int(feats.valid.sum())
        if self.init_feats is None:
            if n_valid > cfg.tracking.init_min_keypoints:
                self.init_feats, self.init_ts = feats, ts
                self.state = NOT_INITIALIZED
            return TrackerOutput(self.state, None, 0, False)
        if n_valid <= cfg.tracking.init_min_keypoints:
            self.init_feats = None
            return TrackerOutput(self.state, None, 0, False)
        idx, _ = matcher.search_for_initialization(
            self.init_feats, feats, window=cfg.tracking.init_window,
            nn_ratio=cfg.matcher.nn_ratio_motion)
        ok = idx >= 0
        n_matches = int(ok.sum())
        if n_matches < cfg.tracking.init_min_matches:
            self.init_feats, self.init_ts = feats, ts
            return TrackerOutput(self.state, None, n_matches, False)
        i2 = idx.clamp(min=0)
        oct_pair = torch.maximum(self.init_feats.octave, feats.octave[i2])
        res = initialize_two_view(
            self.init_feats.xy_und, feats.xy_und[i2], ok, self.K,
            self.init_draws(self.frame_id, n_matches),
            sigma2=self.sigma2[oct_pair.clamp(0, cfg.orb.n_levels - 1)],
        )
        if not bool(res.success):
            return TrackerOutput(self.state, None, n_matches, False)
        self.m, f2 = build_initial_map(
            self.m, self.init_feats, feats, idx, res.is_point & ok, res.points, res.Tcw2,
            self.frame_id - 1, self.init_ts, self.frame_id, ts, self.K, self.inv_sigma2,
            self.scale_factors, n_out=cfg.orb.n_features,
        )
        kf1 = 1   # initialization starts from an empty map: kf0 = 0
        self.n_kf_host = 2
        self.last_feats, self.last_obs = f2, self.m.kf_obs[kf1]
        self.last_Tcw, self.velocity = self.m.kf_pose[kf1], None
        self.ref_kf, self.last_kf_frame = kf1, self.frame_id
        self._register_kf_bow(0)
        self._register_kf_bow(1)
        self.state = OK
        return TrackerOutput(OK, self.last_Tcw, int(res.n_good), True)

    def _track(self, feats: FrameFeatures, ts: float) -> TrackerOutput:
        t = self.cfg.tracking
        # right after a relocalization: the local-map window widens 5x
        # (Tracking.cc:1452) and, within mMaxFrames, the inlier floor is 50
        # (Tracking.cc:1200-1206)
        just_reloc = self.frame_id < self.last_reloc_frame + 2
        recent_reloc = self.frame_id < self.last_reloc_frame + t.max_frames_between_kf
        r = track_step(
            self.m, feats, self.last_obs, self.last_feats.octave, self.last_feats.angle,
            self.velocity, self.last_Tcw, self.ref_kf, self.K, self.scale_factors,
            self.inv_sigma2, self.cfg, 5.0 if just_reloc else 1.0, self.bounds,
            ur=self._cur_ur, bf=self.bf, depth=self._cur_depth,
            depth_threshold=self.depth_threshold,
        )
        self.m = r.m
        min_local = t.min_inliers_localmap_reloc if recent_reloc else t.min_inliers_localmap
        if not r.ok1 or r.n_inl2 < min_local:
            self.state = LOST
            if r.n_kf_valid <= t.auto_reset_max_kfs:   # Tracking.cc:646-656
                self.reset()
            return TrackerOutput(LOST, None, r.n_inl2 if r.ok1 else r.n_inl1, False)
        self.velocity, self.last_Tcw = r.velocity, r.Tcw
        self.last_feats, self.last_obs = feats, r.cur_obs
        created = False
        if self._need_new_keyframe(r.n_inl2, r.n_ref, r.n_kf_valid, r.n_close_t, r.n_close_u):
            self._create_keyframe(feats, r.Tcw, r.cur_obs, ts)
            created = True
        return TrackerOutput(OK, r.Tcw, r.n_inl2, created, T_cr=r.T_cr)

    def _need_new_keyframe(self, n_inliers: int, n_ref: int, n_kf_valid: int,
                           n_close_tracked: int = 0, n_close_untracked: int = 0) -> bool:
        """NeedNewKeyFrame (src/Tracking.cc:1210-1310). The stereo / RGB-D
        sensors add ratioMap (close map matches / all close-depth features),
        thRefRatio 0.75 (0.4 below 2 keyframes) and c1c, "tracking is weak",
        which forces an insertion like c1a."""
        cfg = self.cfg
        fid = self.frame_id
        if not self.allow_keyframes:                 # localization mode (Tracking.cc:1213)
            return False
        if self.n_kf_host >= self.m.max_kf - 1:
            return False
        # no keyframe right after a relocalization once the map is mature
        # (Tracking.cc:1222)
        mf = cfg.tracking.max_frames_between_kf
        if fid < self.last_reloc_frame + mf and n_kf_valid > mf:
            return False
        mono = cfg.sensor == "monocular"
        n_close = n_close_tracked + n_close_untracked
        ratio_map = 1.0 if mono else n_close_tracked / max(1, n_close)
        if mono:
            th_ref = cfg.tracking.keyframe_min_ratio
        else:
            th_ref = 0.4 if n_kf_valid < 2 else 0.75     # Tracking.cc:1265-1271
        th_map = 0.20 if n_inliers > 300 else 0.35        # Tracking.cc:1273
        c2 = (n_inliers < n_ref * th_ref or ratio_map < th_map) and n_inliers > 15
        if n_ref == 0:
            # right after a depth initialization no point has 2 observations
            # yet: accept on raw inliers (as the JAX package does)
            c2 = n_inliers > 15
        if not c2:
            return False
        c1a = fid >= self.last_kf_frame + cfg.tracking.max_frames_between_kf
        idle = self.mapper_idle_hook() if self.mapper_idle_hook else True
        c1b = fid >= self.last_kf_frame + cfg.tracking.min_frames_between_kf and idle
        c1c = not mono and (n_inliers < n_ref * 0.25 or ratio_map < 0.3)   # Tracking.cc:1280
        if (c1a or c1c) and not idle:
            # forced insertion: abort the BA chunks not yet issued and adopt
            # the pass (InterruptBA, Tracking.cc:1287-1303)
            self.mapper_idle_hook(force=True, abort=True)
        return bool(c1a or c1b or c1c)

    def _create_keyframe(self, feats: FrameFeatures, Tcw, cur_obs, ts: float) -> None:
        """CreateNewKeyFrame (src/Tracking.cc:1312-1407) + the mapping pass;
        a frame with depth also grows points from it."""
        if self.n_kf_host >= self.m.max_kf:
            return
        if self._cur_depth is not None:
            self.m, kf = freeze_kf_depth(
                self.m, Tcw, feats, cur_obs, self.frame_id, ts, self.ref_kf, self._cur_depth,
                self.camera, self.depth_threshold, self.scale_factors, self.bf)
        else:
            self.m, kf = mt.add_keyframe(
                self.m, Tcw, feats.xy_und, feats.octave, feats.angle, feats.desc,
                feats.valid, cur_obs, self.frame_id, ts, self.ref_kf)
        self.n_kf_host += 1
        self.ref_kf = kf
        self.last_kf_frame = self.frame_id
        self._register_kf_bow(kf)
        if self.mapping_hook is not None:
            self.mapping_hook(kf)

    def _register_kf_bow(self, kf: int) -> None:
        """Add the keyframe to the recognition database; train the
        vocabulary at 4 keyframes, retrain it at 16 and 64 on every keyframe
        slot (a pre-trained vocabulary is never retrained)."""
        m = self.m
        self.bow.add(kf, m.kf_desc[kf], m.kf_feat_valid[kf])
        n = self.n_kf_host
        if not self.bow.ready and n >= 4:
            self.bow.maybe_train(m.kf_desc[:n].reshape(-1, 8), m.kf_feat_valid[:n].reshape(-1),
                                 self.vocab_draws(self.cfg.seed + 7, n * m.n_feat))
            self.vocab_trainings.append((n, self.frame_id))
        elif n in (16, 64) and not self.bow.pretrained:
            self.bow.retrain(m.kf_desc, m.kf_feat_valid, m.kf_valid,
                             self.vocab_draws(self.cfg.seed + 7 + n, m.max_kf * m.n_feat))
            self.vocab_trainings.append((n, self.frame_id))

    def _reloc_candidates(self, feats: FrameFeatures) -> list[int]:
        """BoW candidate keyframes (KeyFrameDatabase::
        DetectRelocalizationCandidates, src/KeyFrameDatabase.cc:208-328), best
        first, at most RELOC_CANDIDATES; without a vocabulary, or without a
        BoW candidate, the descriptor-match ranking of every keyframe."""
        if not self.bow.ready:
            return self._reloc_candidates_untrained(feats)
        m = self.m
        self.bow.mask_valid(m.kf_valid)    # culled keyframes leave the database
        v = self.bow.query_vector(feats.desc, feats.valid)
        acc, keep = self.bow.candidates(v, ~m.kf_valid, covisibility_matrix(m).float())
        acc = torch.where(keep, acc, -1.0).cpu().numpy()
        order = np.argsort(-acc)        # numpy's default sort, as the JAX package's
        cands = [int(k) for k in order[:RELOC_CANDIDATES] if acc[k] > 0]
        return cands or self._reloc_candidates_untrained(feats)

    def _reloc_candidates_untrained(self, feats: FrameFeatures) -> list[int]:
        """Every valid keyframe ranked by its descriptor match count with the
        frame."""
        m = self.m
        valid_slots = torch.nonzero(m.kf_valid).flatten().tolist()
        if not valid_slots:
            return [self.ref_kf]
        counts = []
        for k in valid_slots:
            idx, _ = matcher.match_by_descriptor(
                m.kf_desc[k], feats.desc, (m.kf_obs[k] >= 0) & m.kf_feat_valid[k], feats.valid,
                nn_ratio=self.cfg.matcher.nn_ratio_bow)
            counts.append((idx >= 0).sum(dtype=torch.int32))
        order = np.argsort(-torch.stack(counts).cpu().numpy())
        return [valid_slots[i] for i in order[:RELOC_CANDIDATES]]

    def _relocalize(self, feats: FrameFeatures, ts: float) -> TrackerOutput:
        """Tracking::Relocalization (src/Tracking.cc:1628-1833): BoW
        candidates, then each one's cascade; accept the best at >=
        reloc_min_inliers inliers."""
        cfg = self.cfg
        cands = self._reloc_candidates(feats)
        if not cands:
            return TrackerOutput(LOST, None, 0, False)
        fid = self.frame_id
        n_good, Tcws, obs = _reloc_program(
            self.m, feats, cands, lambda k, n: self.pnp_draws(fid, k, n), self.K,
            self.inv_sigma2, self.scale_factors, cfg.matcher.nn_ratio_bow, cfg.matcher.th_low,
            cfg.orb.n_levels, cfg.matcher.histo_length, cfg.tracking.reloc_min_inliers,
            ur=self._cur_ur, bf=self.bf,
        )
        self.last_reloc_attempt = dict(frame=fid, candidates=cands, n_good=n_good)
        b = int(np.argmax(n_good))
        if n_good[b] < cfg.tracking.reloc_min_inliers:
            return TrackerOutput(LOST, None, n_good[b], False)
        self.state = OK
        self.last_Tcw, self.last_feats, self.last_obs = Tcws[b], feats, obs[b]
        self.velocity = None
        self.last_reloc_frame = fid
        return TrackerOutput(OK, Tcws[b], n_good[b], False)

    def reset(self) -> None:
        """Tracking::Reset (src/Tracking.cc:1835-1870): a fresh map, BoW index
        and per-frame state. The trajectory is kept, each entry baked to its
        absolute pose (ref -1) while the old keyframe poses still exist."""
        if self.trajectory:
            T_cr = torch.stack([p for _, p, _ in self.trajectory])
            refs = torch.tensor([r for _, _, r in self.trajectory], device=self.device)
            anchor = torch.where((refs >= 0)[:, None, None], self.m.kf_pose[refs.clamp(min=0)],
                                 self.eye4)
            baked = T_cr @ anchor
            self.trajectory = [(ts, baked[i], -1) for i, (ts, _, _) in enumerate(self.trajectory)]
        if self.reset_hook is not None:
            self.reset_hook()
        self._clear_session()
        self.resets += 1

    def load_map(self, m: SlamMap) -> None:
        """Adopt a loaded map (slam_map/checkpoint.py) and restore what a
        live session needs: the allocated-slot counter, the reference
        keyframe (the last valid one) and the BoW database, rebuilt from the
        valid keyframes (the vocabulary retrained on them from 4 keyframes
        on). The session enters LOST: the next frame relocalizes."""
        if self.reset_hook is not None:
            self.reset_hook()
        self.m = m
        slots = np.flatnonzero(m.kf_valid.cpu().numpy())
        self.n_kf_host = int(m.n_kf)
        self.ref_kf = int(slots[-1]) if slots.size else 0
        self.state = LOST if slots.size else NO_IMAGES_YET
        self.last_feats = self.last_obs = self.velocity = self.init_feats = None
        self.last_Tcw = self.eye4
        self.last_kf_frame = self.frame_id
        self.last_reloc_frame = -(10**9)
        self.bow = self._make_bow()
        if self.bow.pretrained:
            self.bow.reindex(m.kf_desc, m.kf_feat_valid, m.kf_valid)
        elif slots.size >= 4:
            self.bow.retrain(m.kf_desc, m.kf_feat_valid, m.kf_valid,
                             self.vocab_draws(self.cfg.seed + 7, m.max_kf * m.n_feat))
            self.vocab_trainings.append((int(slots.size), self.frame_id))
        else:
            for k in slots.tolist():
                self.bow.add(k, m.kf_desc[k], m.kf_feat_valid[k])

    def trajectory_Twc(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (F,), Twc (F,4,4)): each logged keyframe-relative pose
        composed with its reference keyframe's current pose."""
        if not self.trajectory:
            return np.zeros(0), np.zeros((0, 4, 4))
        ts = np.asarray([t for t, _, _ in self.trajectory])
        T_cr = torch.stack([p for _, p, _ in self.trajectory])
        refs = torch.tensor([r for _, _, r in self.trajectory], device=self.device)
        anchor = torch.where((refs >= 0)[:, None, None], self.m.kf_pose[refs.clamp(min=0)], self.eye4)
        Tcw = (T_cr @ anchor).double().cpu().numpy()
        return ts, np.linalg.inv(Tcw)
