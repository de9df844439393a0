"""Per-frame tracking: the front-end state machine (port of
weiner_slamit_v2_tpu/tracking/tracker.py; Tracking,
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

``enable_posenet()`` runs the PoseNet person-keypoint head (models/) on
every frame before extraction; ``last_person`` holds its result.

The tracking step (``track_step``) reads nothing back to the host: every
decision is a selection on the device, and the host reads one packed scalar
vector per frame. With ``frames_per_sync`` N > 1 (the JAX package's
pipelined mode) a warmed-up session in the OK state buffers its frames,
uploaded through pinned memory without a synchronization, and tracks them N
at a time with no host synchronization (``_launch_batch``). A batch's LOST
and keyframe decisions resolve when the next batch has been launched
(``_resolve_pending``), so they land up to 2N-1 frames late; a loss in a
batch rolls the point counters back to the loss frame and logs the rest of
the batch as lost.
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
from ..models import posenet
from ..optim import pnp
from ..optim.local_ba import BAProblem, solve_ba
from ..optim.pose_opt import capture_tail, optimize_pose
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


# The packed per-frame scalars of track_step, in the JAX package's layout
# (tracking/tracker.py:506-516): the one host read of a tracked frame.
S_N_MATCHES = 0
S_USED_REF = 1
S_N_INL1 = 2
S_N_INL2 = 3
S_OK1 = 4
S_N_REF = 5
S_N_KF = 6
S_N_CLOSE_T = 7
S_N_CLOSE_U = 8
N_SCALARS = 9


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(M,) bool -> (M/32,) int32 bit patterns of the uint32 words, bit j of
    word w = mask[32 w + j] (M is a multiple of 32, as map capacities are):
    a frame's counter increments, kept for the rollback after a loss."""
    b = mask.reshape(-1, 32).to(torch.int64) << torch.arange(32, device=mask.device)
    w = b.sum(1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _unpack_bits(packed: torch.Tensor, m_size: int) -> torch.Tensor:
    """(..., M/32) packed words -> (..., M) bool."""
    bits = (packed.to(torch.int64)[..., None] >> torch.arange(32, device=packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], m_size).bool()


def _counters_at(snap_visible, snap_found, inc_vis, inc_found, upto: int):
    """The counter planes as of frame ``upto`` of a pipelined batch: the
    snapshot plus the packed increments (B, M/32) of frames [0, upto). The
    reference never updates the statistics from lost frames
    (Tracking.cc:1409-1447); this rolls back the ones frames tracked after a
    loss chained in before it was detected."""
    M = snap_visible.shape[0]
    dv = _unpack_bits(inc_vis[:upto], M).sum(0, dtype=torch.int32)
    df = _unpack_bits(inc_found[:upto], M).sum(0, dtype=torch.int32)
    return snap_visible + dv, snap_found + df


@dataclass
class StepResult:
    m: SlamMap            # the map with the frame's counter increments
    Tcw: torch.Tensor
    cur_obs: torch.Tensor
    velocity: torch.Tensor
    T_cr: torch.Tensor
    scalars: torch.Tensor   # (N_SCALARS,) int32, S_* layout
    inc: tuple              # (visible, found) increments, _pack_bits words


def track_step(m: SlamMap, feats: FrameFeatures, last_obs, last_octave, last_angle,
               velocity: Optional[torch.Tensor], last_Tcw, ref_kf: int, K, scale_factors,
               inv_sigma2, cfg: SlamConfig, local_th: float, bounds, ur=None, bf: float = 0.0,
               depth=None, depth_threshold: float = 0.0) -> StepResult:
    """One tracking step in the OK state (Tracking::Track,
    src/Tracking.cc:385-694; JAX ``_track_step_impl``): motion-model match
    with the 2x window retry or the reference-keyframe fallback, pose LM,
    local-map match, pose LM, point counters and the NeedNewKeyFrame
    statistics. It reads nothing back to the host: both motion windows and
    the reference-keyframe match always run and ``torch.where`` picks (the
    JAX package's ``lax.cond`` runs one branch; the results are the same),
    the counters advance under ``ok1`` on the device, and the decisions come
    back as one packed scalar vector. ur (N,): the frame's stereo right-u
    (-1 = none), for the stereo rows of both pose LMs and the one-sided
    octave gate; depth (N,): per-feature depth, for the close-point counts
    of the stereo keyframe gate (Tracking.cc:1238-1283)."""
    t, mc, o = cfg.tracking, cfg.matcher, cfg.optim
    n_levels, hb = cfg.orb.n_levels, mc.histo_length
    Tcw_pred = se3.matmul(velocity, last_Tcw) if velocity is not None else last_Tcw
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

    obs_a, n_a = motion(window)
    obs_w, n_w = motion(2.0 * window)               # widen 2x (Tracking.cc:1108-1121)
    widen = n_a < t.min_matches_motion
    obs_b, n_b = torch.where(widen, obs_w, obs_a), torch.where(widen, n_w, n_a)
    need_ref = n_b < t.min_matches_motion           # TrackReferenceKeyFrame (Tracking.cc:449)
    obs_r, n_r = _match_reference_kf(m, feats, ref_kf, mc.nn_ratio_refkf, mc.th_low, hb)
    obs_c, n_c = torch.where(need_ref, obs_r, obs_b), torch.where(need_ref, n_r, n_b)
    Tcw0 = torch.where(need_ref, last_Tcw, Tcw_pred)
    enough = n_c >= torch.where(need_ref, t.min_matches_refkf, t.min_matches_motion)

    Tcw1, obs, n_i1 = _pose_opt_on_obs(m, feats, obs_c, Tcw0, K, inv_sigma2,
                                       o.pose_opt_rounds, o.pose_opt_iters, o.lm_lambda_init, ur, bf)
    ok1 = enough & (n_i1 >= t.min_inliers_motion)
    obs, visible = _track_local_map(
        m, feats, obs, Tcw1, K, scale_factors, local_th, n_levels, mc.nn_ratio_localmap,
        mc.th_high, cfg.capacity.local_ba_points, t.local_map_kf_cap, bounds,
    )
    Tcw2, obs, n_i2 = _pose_opt_on_obs(m, feats, obs, Tcw1, K, inv_sigma2,
                                       o.pose_opt_rounds, o.pose_opt_iters, o.lm_lambda_init, ur, bf)
    return _step_tail(m, feats, obs, visible, ok1, n_c, need_ref, n_i1, n_i2, Tcw2, last_Tcw,
                      ref_kf, depth, depth_threshold)


def _step_tail(m: SlamMap, feats: FrameFeatures, obs, visible, ok1, n_c, need_ref, n_i1, n_i2,
               Tcw2, last_Tcw, ref_kf: int, depth=None, depth_threshold: float = 0.0) -> StepResult:
    """The end of ``track_step`` after the second pose LM: the point counters
    (IncreaseVisible / IncreaseFound, Tracking.cc:1409-1447, advanced only
    when the stages before the local map succeeded), the NeedNewKeyFrame
    statistics, the velocity and the packed scalars."""
    found = put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device),
                torch.where(obs >= 0, obs.clamp(min=0), m.max_mp), True)
    inc_vis, inc_found = (visible | found) & ok1, found & ok1
    m2 = m.replace(mp_visible=m.mp_visible + inc_vis.to(torch.int32),
                   mp_found=m.mp_found + inc_found.to(torch.int32))

    n_kf_valid = m.kf_valid.sum()
    min_obs = torch.where(n_kf_valid > 2, 3, 2)
    robs = m.kf_obs[ref_kf]
    rmp = robs.clamp(min=0)
    rhas = (robs >= 0) & m.kf_feat_valid[ref_kf] & m.mp_valid[rmp]
    n_ref = (rhas & (m.mp_n_obs[rmp] >= min_obs)).sum()
    if depth is not None:
        # ratioMap's counts (Tracking.cc:1238-1263): close-depth features
        # matched to an observed map point, and the rest
        close = feats.valid & (depth > 0) & (depth < depth_threshold)
        mp_of = obs.clamp(min=0)
        has_map = (obs >= 0) & m.mp_valid[mp_of] & (m.mp_n_obs[mp_of] > 0)
        n_close_t, n_close_u = (close & has_map).sum(), (close & ~has_map).sum()
    else:
        n_close_t = n_close_u = torch.zeros((), dtype=torch.int32, device=m.device)
    scalars = torch.stack([v.to(torch.int32) for v in (
        n_c, need_ref, n_i1, n_i2, ok1, n_ref, n_kf_valid, n_close_t, n_close_u)])
    return StepResult(
        m=m2, Tcw=Tcw2, cur_obs=obs, velocity=se3.matmul(Tcw2, se3.inv(last_Tcw)),
        T_cr=se3.matmul(Tcw2, se3.inv(m.kf_pose[ref_kf])), scalars=scalars,
        inc=(_pack_bits(inc_vis), _pack_bits(inc_found)),
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
    # a pipelined frame (frames_per_sync > 1): state and Tcw are speculative
    # until its batch resolves, n_inliers is -1, and its trajectory entry is
    # logged at resolution
    deferred: bool = False


class _UploadRing:
    """Pinned host buffers through which buffered frames go to the card with
    ``non_blocking=True`` (no stream synchronization; the JAX package's
    asynchronous ``device_put``). Each slot's event, recorded after its
    copies, keeps the slot from being overwritten before they have landed."""

    def __init__(self, depth: int, device: torch.device):
        self.device = device
        self.bufs: list[dict] = [{} for _ in range(depth)]
        self.events: list = [None] * depth
        self.next = 0

    def upload(self, arrays: dict) -> dict:
        """{name: numpy array} -> {name: tensor on the card}."""
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()
        out = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            buf = self.bufs[i].get(name)
            if buf is None or tuple(buf.shape) != a.shape or buf.numpy().dtype != a.dtype:
                buf = self.bufs[i][name] = torch.from_numpy(np.empty_like(a)).pin_memory()
            buf.numpy()[...] = a
            out[name] = buf.to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record(torch.cuda.current_stream(self.device))
        return out


class _HostScalars:
    """A batch's (B, N_SCALARS) scalars, copied to pinned host memory behind
    an event without a synchronization; ``rows()`` waits on the event: the
    one host wait of a pipelined batch, made one batch later."""

    def __init__(self, scalars: torch.Tensor):
        self.event = None
        if scalars.is_cuda:
            self.host = torch.empty(scalars.shape, dtype=scalars.dtype, pin_memory=True)
            self.host.copy_(scalars, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(scalars.device))
        else:
            self.host = scalars
        self._rows = None

    def rows(self) -> list:
        if self._rows is None:
            if self.event is not None:
                self.event.synchronize()
            self._rows = self.host.tolist()
        return self._rows


class Tracker:
    """Tracking session: owns the map, the BoW index and the per-frame
    state."""

    def __init__(self, cfg: SlamConfig, camera: Camera, device=None):
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
        if dev.type == "cuda":
            capture_tail(dev)   # the pose LM's graph, before any step
        # Camera.bf and the depth gate as float32 values, as the JAX package
        # passes them; the stereo matcher's least depth is the baseline
        # (Frame.cc:610)
        bf = np.float32(cfg.camera.baseline_times_fx)
        self.bf = float(bf)
        self.min_z = float(np.float32(bf / cfg.camera.fx if bf > 0 else 0.0))
        self.depth_threshold = float(np.float32(cfg.camera.depth_threshold))
        self.frame_id = -1
        self._upload_ring: Optional[_UploadRing] = None   # made at the first buffered frame
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
        self.loss_frames: list[int] = []   # the frames tracking was lost on
        self.batches_launched = 0          # full pipelined batches (_launch_batch)
        # the PoseNet person-keypoint head, run on every frame once
        # enable_posenet() is called (src/Frame.cc:222-334); last_person holds
        # its (positions (17, 2), scores (17,), scores > 0.7) device tensors
        self.posenet = None
        self.last_person: Optional[tuple] = None

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
        self._drop_pending()

    def _drop_pending(self) -> None:
        """Forget the pipelined state (frames_per_sync > 1): frames tracked but
        not resolved (each record keeps what its LOST and keyframe decisions
        need), frames buffered for the next batch and their sensor mode, the
        counter snapshot at the head of the unresolved frames (for the
        rollback after a loss), and ``culled_remap``: culled slot ->
        (T_culled_parent, surviving ancestor), for records still in flight
        whose reference keyframe a mapping pass culled (the mTcp mechanism,
        src/KeyFrame.cc:460-552)."""
        self._pending_frames: list[dict] = []
        self._img_buffer: list[dict] = []
        self._scan_mode = "mono"
        self._batch_counters = None
        self.culled_remap: dict = {}

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

    def enable_posenet(self, params=None) -> None:
        """Run the PoseNet head on every frame, as the reference does in the
        Frame ctor (src/Tracking.cc:184-187, src/Frame.cc:222-232). params: a
        ``models.posenet.PoseNet`` (e.g. from ``load_params``); None draws
        random weights from a generator seeded cfg.seed + 99 (no trained
        weights are in the repository)."""
        if params is None:
            params = posenet.init_params(torch.Generator().manual_seed(self.cfg.seed + 99))
        self.posenet = params.to(self.device)

    def _extract(self, image: torch.Tensor, initializing: bool) -> FrameFeatures:
        ex = self.init_extractor if initializing else self.extractor
        feats = ex(image)
        return feats.replace(xy_und=self.camera.undistort_points(feats.xy))

    def process_frame(self, image, timestamp: float, depth=None, image_right=None) -> TrackerOutput:
        """Track one (H, W) uint8 or float32 frame. ``depth`` (H, W) meters
        selects the RGB-D path, ``image_right`` (the rectified right view)
        the stereo path. With frames_per_sync > 1, once the map holds
        pipeline_warmup_kfs keyframes (or in localization mode), frames in
        the OK state are buffered and tracked frames_per_sync at a time
        (``_run_scan_batch``)."""
        self.frame_id += 1
        mode = "mono" if depth is None and image_right is None else (
            "rgbd" if depth is not None else "stereo")
        t = self.cfg.tracking
        if (self.state == OK and t.frames_per_sync > 1
                and (self.n_kf_host >= t.pipeline_warmup_kfs or not self.allow_keyframes)
                and self.frame_id >= self.last_reloc_frame + 2
                # batch records may stay deferred past a batch; per-frame ones may not
                and all(r["batched"] for r in self._pending_frames)
                and (not self._img_buffer or self._scan_mode == mode)):
            return self._buffer_frame(image, timestamp, depth, image_right, mode)
        # a frame off the fast path tracks the buffered frames first, in order
        self._drain_img_buffer()
        upload = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)  # noqa: E731
        img = upload(image)
        if self.posenet is not None:
            # every frame, blank and lost ones too; no host read
            self.last_person = posenet.person_keypoints_for_frame(self.posenet, img)
        initializing = self.state in (NO_IMAGES_YET, NOT_INITIALIZED)
        # the depth modes always extract with the map's feature budget
        feats, feat_depth = self._features(
            img, None if depth is None else upload(np.asarray(depth, np.float32)),
            None if image_right is None else upload(image_right),
            initializing and mode == "mono")
        self._set_cur_depth(feats, feat_depth)
        if initializing and feat_depth is not None:
            out = self._initialize_with_depth(feats, feat_depth, timestamp)
        elif initializing:
            out = self._try_initialize(feats, timestamp)
        elif self.state == OK:
            out = self._track(feats, timestamp)
        else:
            out = self._relocalize(feats, timestamp)
        if out.deferred:
            return out     # logged at resolution
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

    def _features(self, img, dmap, img_r, initializing: bool = False):
        """(features, per-feature depth or None) of a frame on the device:
        extraction, undistortion, and the depth lookup (RGB-D, ``dmap``) or
        the second extraction and the stereo match (``img_r``)."""
        feats = self._extract(img, initializing)
        if dmap is not None:
            return feats, depth_from_depthmap(feats, dmap)
        if img_r is not None:
            fd, _ = match_stereo(feats, self.extractor(img_r), img.to(torch.float32),
                                 img_r.to(torch.float32), self.bf, self.min_z,
                                 self.scale_factors, self.cfg.orb.n_levels)
            return feats, fd
        return feats, None

    def _set_cur_depth(self, feats: FrameFeatures, feat_depth) -> None:
        self._cur_depth = feat_depth
        self._cur_ur = None if feat_depth is None else _right_u(feats, feat_depth, self.bf)

    def _buffer_frame(self, image, ts: float, depth, image_right, mode: str) -> TrackerOutput:
        """The pipelined fast path (JAX tracking/tracker.py:1140-1183): upload
        the frame without a synchronization and buffer it; a full buffer
        launches a batch, whose decisions resolve one batch later."""
        t = self.cfg.tracking
        arrays = {"img": image}
        if depth is not None:
            arrays["dmap"] = np.asarray(depth, np.float32)
        if image_right is not None:
            arrays["img_r"] = image_right
        if self.device.type == "cuda":
            if self._upload_ring is None:
                self._upload_ring = _UploadRing(t.frames_per_sync + 1, self.device)
            frame = self._upload_ring.upload(arrays)
        else:
            frame = {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}
        if self.posenet is not None:
            self.last_person = posenet.person_keypoints_for_frame(self.posenet, frame["img"])
        self._cur_depth = self._cur_ur = None
        self._scan_mode = mode
        self._img_buffer.append(dict(
            frame, ts=ts, frame_id=self.frame_id,
            recent_reloc=self.frame_id < self.last_reloc_frame + t.max_frames_between_kf))
        if len(self._img_buffer) >= t.frames_per_sync:
            self._run_scan_batch()
        if self.state != OK:
            return TrackerOutput(self.state, None, -1, False, deferred=True)
        return TrackerOutput(OK, self.last_Tcw, -1, False, deferred=True)

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

    def _track(self, feats: FrameFeatures, ts: float, frame_id: Optional[int] = None) -> TrackerOutput:
        """Track one frame in the OK state. frame_id: the frame's id when it
        is not the current one (a buffered frame of a partial batch). With
        frames_per_sync > 1 and a warmed-up map the step's result is queued
        unread and resolved with its batch; otherwise its scalars are read
        once (one ``tolist``) and decided now."""
        t = self.cfg.tracking
        fid = self.frame_id if frame_id is None else frame_id
        # right after a relocalization: the local-map window widens 5x
        # (Tracking.cc:1452) and, within mMaxFrames, the inlier floor is 50
        # (Tracking.cc:1200-1206)
        just_reloc = fid < self.last_reloc_frame + 2
        recent_reloc = fid < self.last_reloc_frame + t.max_frames_between_kf
        r = track_step(
            self.m, feats, self.last_obs, self.last_feats.octave, self.last_feats.angle,
            self.velocity, self.last_Tcw, self.ref_kf, self.K, self.scale_factors,
            self.inv_sigma2, self.cfg, 5.0 if just_reloc else 1.0, self.bounds,
            ur=self._cur_ur, bf=self.bf, depth=self._cur_depth,
            depth_threshold=self.depth_threshold,
        )
        if t.frames_per_sync > 1 and self.n_kf_host >= t.pipeline_warmup_kfs:
            # the per-frame pipelined variant (frames off the fast path, e.g.
            # right after a relocalization): chain the state unread and
            # resolve every frames_per_sync frames
            if not self._pending_frames:
                self._batch_counters = (self.m.mp_visible, self.m.mp_found)
            self.m = r.m
            self.velocity, self.last_Tcw = r.velocity, r.Tcw
            self.last_feats, self.last_obs = feats, r.cur_obs
            self._pending_frames.append(dict(
                batched=False, scalars=r.scalars, feats=feats, Tcw=r.Tcw, cur_obs=r.cur_obs,
                T_cr=r.T_cr, ts=ts, frame_id=fid, ref_kf=self.ref_kf,
                recent_reloc=recent_reloc, depth=self._cur_depth, inc=r.inc))
            if len(self._pending_frames) >= t.frames_per_sync:
                self._resolve_pending()
            if self.state != OK:     # the resolution found a loss
                return TrackerOutput(self.state, None, -1, False, deferred=True)
            return TrackerOutput(OK, r.Tcw, -1, False, deferred=True)

        # pipelined frames left over (the warmup gate closed again) resolve
        # first, so the trajectory stays in order
        if self._pending_frames:
            self._resolve_pending()
        s = r.scalars.tolist()      # the one host read of the frame
        self.m = r.m
        min_local = t.min_inliers_localmap_reloc if recent_reloc else t.min_inliers_localmap
        if not s[S_OK1] or s[S_N_INL2] < min_local:
            self._lost(fid, s[S_N_KF])
            return TrackerOutput(LOST, None, s[S_N_INL2] if s[S_OK1] else s[S_N_INL1], False)
        self.velocity, self.last_Tcw = r.velocity, r.Tcw
        self.last_feats, self.last_obs = feats, r.cur_obs
        created = False
        if self._need_new_keyframe(s[S_N_INL2], s[S_N_REF], s[S_N_KF], s[S_N_CLOSE_T],
                                   s[S_N_CLOSE_U], frame_id=fid):
            self._create_keyframe(feats, r.Tcw, r.cur_obs, ts, frame_id=fid)
            created = True
        return TrackerOutput(OK, r.Tcw, s[S_N_INL2], created, T_cr=r.T_cr)

    def _lost(self, frame_id: int, n_kf_valid: int) -> None:
        """Enter LOST on frame frame_id; a loss while the map holds <=
        auto_reset_max_kfs keyframes resets the session (Tracking.cc:646-656)."""
        self.state = LOST
        self.loss_frames.append(frame_id)
        if n_kf_valid <= self.cfg.tracking.auto_reset_max_kfs:
            self.reset()

    def flush_pending(self) -> None:
        """Track the buffered frames and resolve every pipelined frame (one
        host wait). Called before anything on the host reads the tracker's
        state: trajectory export, reset, compaction, adoptions, map views."""
        self._drain_img_buffer()
        self._resolve_pending()

    def _drain_img_buffer(self) -> None:
        if self._img_buffer:
            self._run_scan_batch()

    def _run_scan_batch(self) -> None:
        """Track the buffered frames: a full batch through ``_launch_batch``,
        with the batch before it resolved meanwhile (its host wait overlaps
        this batch on the device); a partial one (a flush mid-batch) through
        the per-frame path, resolved at once."""
        recs, self._img_buffer = self._img_buffer, []
        if not recs:
            return
        if len(recs) != self.cfg.tracking.frames_per_sync:
            for r in recs:
                if self.state != OK:
                    if self.trajectory:
                        self.trajectory.append((r["ts"], *self.trajectory[-1][1:]))
                    continue
                feats, fd = self._features(r["img"], r.get("dmap"), r.get("img_r"))
                self._set_cur_depth(feats, fd)
                self._track(feats, r["ts"], frame_id=r["frame_id"])
            self._resolve_pending()
            return
        self._launch_batch(recs)
        # the batch just launched stays deferred: only the older ones resolve
        self._resolve_pending(keep_last=len(recs))

    def _launch_batch(self, recs: list[dict]) -> None:
        """Track a full batch of buffered frames with no host
        synchronization (the JAX package's ``lax.scan`` over
        ``_track_step_impl``, tracking/tracker.py:1464-1547, as a loop of
        sync-free steps): extract, undistort, the depth lookup or the stereo
        match, the step; the loop carries the counter planes, the last
        observations, octaves and angles, the velocity and the pose. The
        records go to ``_pending_frames``; the scalars go to pinned host
        memory behind an event (``_HostScalars``)."""
        cfg = self.cfg
        snapshot = (self.m.mp_visible, self.m.mp_found)
        m, lobs, Tcw, vel = self.m, self.last_obs, self.last_Tcw, self.velocity
        loct, lang = self.last_feats.octave, self.last_feats.angle
        steps = []
        for r in recs:
            feats, fd = self._features(r["img"], r.get("dmap"), r.get("img_r"))
            ur = None if fd is None else _right_u(feats, fd, self.bf)
            st = track_step(m, feats, lobs, loct, lang, vel, Tcw, self.ref_kf, self.K,
                            self.scale_factors, self.inv_sigma2, cfg, 1.0, self.bounds, ur=ur,
                            bf=self.bf, depth=fd, depth_threshold=self.depth_threshold)
            steps.append((feats, fd, st))
            m, lobs, Tcw, vel = st.m, st.cur_obs, st.Tcw, st.velocity
            loct, lang = feats.octave, feats.angle
        host = _HostScalars(torch.stack([st.scalars for _, _, st in steps]))
        self.batches_launched += 1
        self.m = m
        self.velocity, self.last_Tcw, self.last_obs = vel, Tcw, lobs
        self.last_feats = steps[-1][0]
        if self._batch_counters is None:
            self._batch_counters = snapshot
        for i, (r, (feats, fd, st)) in enumerate(zip(recs, steps)):
            self._pending_frames.append(dict(
                batched=True, scalars=(host, i), feats=feats, Tcw=st.Tcw, cur_obs=st.cur_obs,
                T_cr=st.T_cr, ts=r["ts"], frame_id=r["frame_id"], ref_kf=self.ref_kf,
                recent_reloc=r["recent_reloc"], depth=fd, inc=st.inc))

    def _resolve_pending(self, keep_last: int = 0) -> None:
        """Resolve the pipelined frames in order (JAX tracking/tracker.py:
        1655-1790): log each one's trajectory entry, replay its LOST test and
        its keyframe decision (a keyframe is made from the record of the
        frame that earned it, up to a batch late). keep_last > 0 leaves the
        newest records (the batch just launched) for the next resolution.

        A loss rolls the visible / found counters back to the loss frame,
        logs every later record as lost (they chained on a lost pose; the
        reference repeats the last pose for lost frames, System.cc:420-433)
        and drops them."""
        recs = self._pending_frames
        n_res = len(recs) - keep_last
        if n_res <= 0:
            return
        self._pending_frames = []
        batch_counters, self._batch_counters = self._batch_counters, None
        rows = self._scalar_rows(recs[:n_res])
        t = self.cfg.tracking
        last_created_fid = None
        for i, (rec, s) in enumerate(zip(recs, rows)):
            min_local = t.min_inliers_localmap_reloc if rec["recent_reloc"] else t.min_inliers_localmap
            if not s[S_OK1] or s[S_N_INL2] < min_local:
                if batch_counters is not None:
                    new_v, new_f = _counters_at(*batch_counters,
                                                *(torch.stack(b) for b in zip(*[r["inc"] for r in recs])),
                                                i + 1)
                    self.m = self.m.replace(mp_visible=new_v, mp_found=new_f)
                for rec2 in recs[i:]:
                    if self.trajectory:
                        self.trajectory.append((rec2["ts"], *self.trajectory[-1][1:]))
                self._lost(rec["frame_id"], s[S_N_KF])
                return
            # a later frame of the batch may make a keyframe too if it clears
            # the min-frames gate from the keyframe just made
            gate_ok = (last_created_fid is None
                       or rec["frame_id"] >= last_created_fid + max(t.min_frames_between_kf, 1))
            created = gate_ok and self._need_new_keyframe(
                s[S_N_INL2], s[S_N_REF], s[S_N_KF], s[S_N_CLOSE_T], s[S_N_CLOSE_U],
                frame_id=rec["frame_id"])
            if created:
                self._create_keyframe(rec["feats"], rec["Tcw"], rec["cur_obs"], rec["ts"],
                                      frame_id=rec["frame_id"], depth=rec["depth"])
                last_created_fid = rec["frame_id"]
                self.trajectory.append((rec["ts"], self.eye4, self.ref_kf))
            elif rec["ref_kf"] in self.culled_remap:
                T_cp, new_ref = self.culled_remap[rec["ref_kf"]]
                self.trajectory.append((rec["ts"], rec["T_cr"] @ T_cp, new_ref))
            else:
                self.trajectory.append((rec["ts"], rec["T_cr"], rec["ref_kf"]))
        if keep_last:
            self._pending_frames = recs[n_res:]
        if self._pending_frames and batch_counters is not None:
            # advance the rollback snapshot past the resolved frames
            self._batch_counters = _counters_at(
                *batch_counters, *(torch.stack(b) for b in zip(*[r["inc"] for r in recs[:n_res]])),
                n_res)

    @staticmethod
    def _scalar_rows(recs: list[dict]) -> list:
        """The records' scalar vectors as host lists: a batch's from its
        pinned copy, the per-frame records' in one read."""
        rows = [None] * len(recs)
        plain = [j for j, r in enumerate(recs) if not r["batched"]]
        if plain:
            for j, row in zip(plain, torch.stack([recs[j]["scalars"] for j in plain]).tolist()):
                rows[j] = row
        for j, r in enumerate(recs):
            if r["batched"]:
                host, i = r["scalars"]
                rows[j] = host.rows()[i]
        return rows

    def _need_new_keyframe(self, n_inliers: int, n_ref: int, n_kf_valid: int,
                           n_close_tracked: int = 0, n_close_untracked: int = 0,
                           frame_id: Optional[int] = None) -> bool:
        """NeedNewKeyFrame (src/Tracking.cc:1210-1310). The stereo / RGB-D
        sensors add ratioMap (close map matches / all close-depth features),
        thRefRatio 0.75 (0.4 below 2 keyframes) and c1c, "tracking is weak",
        which forces an insertion like c1a. frame_id: the frame decided
        (default the current one; resolution passes the record's)."""
        cfg = self.cfg
        fid = self.frame_id if frame_id is None else frame_id
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

    def _create_keyframe(self, feats: FrameFeatures, Tcw, cur_obs, ts: float,
                         frame_id: Optional[int] = None, depth=None) -> None:
        """CreateNewKeyFrame (src/Tracking.cc:1312-1407) + the mapping pass;
        a frame with depth also grows points from it. frame_id / depth: the
        frame's (default the current one's; resolution passes the
        record's)."""
        if self.n_kf_host >= self.m.max_kf:
            return
        fid = self.frame_id if frame_id is None else frame_id
        if depth is None:
            depth = self._cur_depth
        if depth is not None:
            self.m, kf = freeze_kf_depth(
                self.m, Tcw, feats, cur_obs, fid, ts, self.ref_kf, depth,
                self.camera, self.depth_threshold, self.scale_factors, self.bf)
        else:
            self.m, kf = mt.add_keyframe(
                self.m, Tcw, feats.xy_und, feats.octave, feats.angle, feats.desc,
                feats.valid, cur_obs, fid, ts, self.ref_kf)
        self.n_kf_host += 1
        self.ref_kf = kf
        self.last_kf_frame = fid
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
        self._drop_pending()
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
        composed with its reference keyframe's current pose; the pipelined
        frames are resolved first."""
        self.flush_pending()
        if not self.trajectory:
            return np.zeros(0), np.zeros((0, 4, 4))
        ts = np.asarray([t for t, _, _ in self.trajectory])
        T_cr = torch.stack([p for _, p, _ in self.trajectory])
        refs = torch.tensor([r for _, _, r in self.trajectory], device=self.device)
        anchor = torch.where((refs >= 0)[:, None, None], self.m.kf_pose[refs.clamp(min=0)], self.eye4)
        Tcw = (T_cr @ anchor).double().cpu().numpy()
        return ts, np.linalg.inv(Tcw)
