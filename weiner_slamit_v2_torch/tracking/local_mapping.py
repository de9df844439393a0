"""Local mapping: cull, triangulate, fuse, local BA (port of
weiner_slamit_v2_tpu/tracking/local_mapping.py: ``mapping_pre``,
``mapping_finish``, their composition ``mapping_step`` and everything they
call; the LocalMapping thread, src/LocalMapping.cc).

Kernel B (ops/match_kernel.py) has one call site: the forward fuse
(``_fuse_match_in_kfs``, inside ``mapping_pre``), one launch over all fuse
targets per mapping pass. The reverse fuse builds its own plain distance
matrix, as the JAX package does. Neighbor and target batches that the JAX
package vmaps are Python loops or leading batch dims here.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..frontend import matcher
from ..geometry import camera, epipolar, se3, triangulate
from ..ops import hamming
from ..ops.match_kernel import windowed_best2
from ..optim.ba_extract import extract_local_ba, write_back_ba
from ..optim.local_ba import solve_ba
from ..slam_map import types as mt
from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.point_stats import predict_octave, refresh_point_stats_touched
from ..slam_map.types import SlamMap
from ..util import nanmedian, put, put_last, topk


def _median_depth_of_kf(m: SlamMap, kf_id: int) -> torch.Tensor:
    """KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:641-671)."""
    obs = m.kf_obs[kf_id]
    has = (obs >= 0) & m.kf_feat_valid[kf_id]
    z = triangulate.depth_in_view(m.kf_pose[kf_id], m.mp_pos[obs.clamp(min=0)])
    med = nanmedian(torch.where(has & (z > 0), z, torch.nan))
    return torch.where(torch.isnan(med), 1.0, med)


def _project_point(K, Tcw, Xw):
    Pc = se3.apply(Tcw, Xw)
    z = torch.where(Pc[..., 2].abs() < 1e-9, 1e-9, Pc[..., 2])
    return torch.stack([K[0, 0] * Pc[..., 0] / z + K[0, 2], K[1, 1] * Pc[..., 1] / z + K[1, 2]], -1)


def _triangulation_candidates(m: SlamMap, kf1: int, kf2, K, scale_factors, sigma2, cfg: SlamConfig):
    """Candidate points between kf1 and one neighbor kf2
    (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:221-505).
    Returns (good (N,), X (N,3), idx (N,), best_dist (N,))."""
    L = sigma2.shape[0]
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    C1, C2 = triangulate.camera_center(T1), triangulate.camera_center(T2)
    baseline = torch.linalg.norm(C2 - C1)
    pair_ok = baseline / torch.clamp(_median_depth_of_kf(m, kf2), min=1e-9) > cfg.mapping.min_baseline_depth_ratio

    un1 = m.kf_feat_valid[kf1] & (m.kf_obs[kf1] < 0)
    un2 = m.kf_feat_valid[kf2] & (m.kf_obs[kf2] < 0)
    xy1, xy2 = m.kf_xy[kf1], m.kf_xy[kf2]
    F12 = epipolar.fundamental_from_poses(T1, T2, K, K)
    n = xy1.shape[0]
    x2h = torch.cat([xy2, torch.ones((n, 1), device=xy2.device)], 1)
    lines = x2h @ F12.T
    num = xy1 @ lines[:, :2].T + lines[None, :, 2]
    den = torch.clamp(lines[:, 0] ** 2 + lines[:, 1] ** 2, min=1e-12)
    oct2 = m.kf_octave[kf2]
    s2_oct2 = sigma2[oct2.clamp(0, L - 1)]
    epi_ok = num * num / den[None, :] < 3.84 * s2_oct2[None, :]
    e12 = _project_point(K, T2, C1)
    far = ((xy2 - e12) ** 2).sum(1) > 100.0 * s2_oct2     # ORBmatcher.cc:749
    dist = hamming.masked_distance_matrix(m.kf_desc[kf1], m.kf_desc[kf2], un1, un2,
                                          epi_ok & far[None, :])
    idx, best, second = hamming.best_and_second(dist)
    ok = (best <= matcher.TH_LOW) & (
        best.float() < cfg.matcher.nn_ratio_triangulation
        * torch.where(second < hamming.INVALID_DIST, second, hamming.INVALID_DIST).float()
    )
    ok &= matcher.column_unique_best(idx, best, ok, n)

    uv2m = xy2[idx.clamp(min=0)]
    X = triangulate.triangulate_dlt(xy1, uv2m, triangulate.projection_matrix(K, T1),
                                    triangulate.projection_matrix(K, T2))
    finite = torch.isfinite(X).all(1)
    cosp = triangulate.parallax_cos(C1, C2, X)
    z1 = triangulate.depth_in_view(T1, X)
    z2 = triangulate.depth_in_view(T2, X)

    def reproj2(T, uv):
        return ((_project_point(K, T, X) - uv) ** 2).sum(1)

    oct1 = m.kf_octave[kf1]
    oct2m = m.kf_octave[kf2][idx.clamp(min=0)]
    err1_ok = reproj2(T1, xy1) < cfg.mapping.chi2_mono * sigma2[oct1.clamp(0, L - 1)]
    err2_ok = reproj2(T2, uv2m) < cfg.mapping.chi2_mono * sigma2[oct2m.clamp(0, L - 1)]
    ratio_dist = torch.linalg.norm(X - C2, dim=1) / torch.clamp(torch.linalg.norm(X - C1, dim=1), min=1e-9)
    ratio_octave = scale_factors[oct1.clamp(0, L - 1)] / scale_factors[oct2m.clamp(0, L - 1)]
    ratio_factor = 1.5 * float(cfg.orb.scale_factor)
    scale_ok = (ratio_dist * ratio_factor > ratio_octave) & (ratio_dist < ratio_octave * ratio_factor)
    good = (ok & pair_ok & finite & (cosp < 0.9998) & (cosp > 0) & (z1 > 0) & (z2 > 0)
            & err1_ok & err2_ok & scale_ok)
    return good, X, idx, best


def triangulate_with_neighbors(m: SlamMap, kf1: int, neighbors, neigh_ok, K, scale_factors,
                               sigma2, cfg: SlamConfig) -> SlamMap:
    """New points against every covisible neighbor; per feature the
    candidate with the smallest descriptor distance wins."""
    cands = [_triangulation_candidates(m, kf1, k2, K, scale_factors, sigma2, cfg)
             for k2 in neighbors.clamp(min=0)]
    good_nn, X_nn, idx_nn, dist_nn = (torch.stack(c) for c in zip(*cands))
    good_nn &= neigh_ok[:, None] & (neighbors[:, None] != kf1)
    n = good_nn.shape[1]
    win = torch.argmin(torch.where(good_nn, dist_nn, 10_000), 0)
    cols = torch.arange(n, device=m.device)
    good, X, idx = good_nn[win, cols], X_nn[win, cols], idx_nn[win, cols]
    kf2 = neighbors[win]
    C1 = triangulate.camera_center(m.kf_pose[kf1])
    L = scale_factors.shape[0]
    d1 = torch.linalg.norm(X - C1, dim=1)
    normal = (X - C1) / torch.clamp(torch.linalg.norm(X - C1, dim=1, keepdim=True), min=1e-9)
    max_dist = d1 * scale_factors[m.kf_octave[kf1].clamp(0, L - 1)]
    m2, _ = mt.add_map_points(
        m, pos=X, desc=m.kf_desc[kf1], normal=normal, min_dist=max_dist / scale_factors[L - 1],
        max_dist=max_dist, kf1=torch.full((n,), kf1, dtype=torch.int32, device=m.device),
        feat1=torch.arange(n, dtype=torch.int32, device=m.device),
        kf2=torch.where(good, kf2, -1), feat2=idx.clamp(min=0), valid=good,
    )
    return m2


def _frustum(m: SlamMap, pid, dst, K, bx):
    """Projection of points ``pid`` (.., S) into keyframes ``dst`` (..)."""
    Tcw = m.kf_pose[dst]
    X = m.mp_pos[pid]
    Pc = (Tcw[..., None, :3, :3] @ X[..., None])[..., 0] + Tcw[..., None, :3, 3]
    z = Pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / zs + K[1, 2]
    ray = X - triangulate.camera_center(Tcw)[..., None, :]
    dist3 = torch.linalg.norm(ray, dim=-1)
    viewcos = (ray * m.mp_normal[pid]).sum(-1) / torch.clamp(dist3, min=1e-9)
    ok = ((z > 0) & (viewcos > 0.5) & (dist3 >= 0.8 * m.mp_min_dist[pid])
          & (dist3 <= 1.2 * m.mp_max_dist[pid])
          & (u >= bx[0]) & (u < bx[1]) & (v >= bx[2]) & (v < bx[3]))
    return u, v, dist3, ok


def _fuse_match_in_kfs(m: SlamMap, pid, p_ok_in, targets, K, scale_factors, inv_sigma2_by_oct,
                       cfg: SlamConfig, window_mult: float):
    """Match-only half of ORBmatcher::Fuse (src/ORBmatcher.cc:829-979) for
    candidate points ``pid`` (S,) into every target keyframe (T,): ONE
    kernel-B launch over the (T, S) problem. Returns (ok (T,S), fidx (T,S))."""
    L = scale_factors.shape[0]
    T, S = targets.shape[0], pid.shape[0]
    already = (m.mp_obs_kf[pid][None, :, :] == targets[:, None, None]).any(-1)
    bx = camera.bounds_from_config(cfg.camera)
    u, v, dist3, vis = _frustum(m, pid[None, :].expand(T, S), targets, K, bx)
    p_ok = p_ok_in[None, :] & m.mp_valid[pid][None, :] & ~already & vis
    pred_oct = predict_octave(dist3, m.mp_max_dist[pid][None, :], scale_factors[1], L)
    octf = m.kf_octave[targets]
    fidx, best, _ = windowed_best2(
        m.mp_desc[pid][None].expand(T, S, 8).contiguous(), m.kf_desc[targets].contiguous(),
        p_ok.contiguous(), m.kf_feat_valid[targets].contiguous(),
        torch.stack([u, v], -1).contiguous(), m.kf_xy[targets].contiguous(),
        (window_mult * scale_factors[pred_oct.clamp(0, L - 1)]).contiguous(),
        (pred_oct - 1).contiguous(), pred_oct.contiguous(), octf.contiguous(),
        inv_sigma2_by_oct[octf.clamp(0, L - 1)].contiguous(), float(cfg.mapping.chi2_mono),
    )
    ok = (best <= cfg.matcher.th_low) & p_ok
    ok = torch.stack([matcher.column_unique_best(fidx[t], best[t], ok[t], m.n_feat) for t in range(T)])
    return ok, fidx.clamp(min=0)


def _fuse_points_into_kf(m: SlamMap, pts_mask, dst: int, K, scale_factors, inv_sigma2_by_oct,
                         cfg: SlamConfig, max_points: int, window_mult: float = 3.0,
                         prefer_src: bool = False) -> SlamMap:
    """ORBmatcher::Fuse of candidate points into keyframe ``dst`` with the
    add / merge (MapPoint::Replace, src/MapPoint.cc:183-221) updates; plain
    distance matrix, as the JAX package does here. window_mult is 3 in
    SearchInNeighbors and 4 in the loop's SearchAndFuse (LoopClosing.cc:612);
    prefer_src makes the projected point win every merge (loop fusion,
    LoopClosing.cc:540-556), not the more-observed one."""
    L = scale_factors.shape[0]
    already = (m.mp_obs_kf == dst).any(1)
    cand = pts_mask & m.mp_valid & ~already
    vals, pid = topk(torch.where(cand, m.mp_n_obs, -1), min(max_points, m.max_mp))
    pid = pid.clamp(min=0)
    bx = camera.bounds_from_config(cfg.camera)
    dst_t = torch.tensor(dst, device=m.device)
    u, v, dist3, vis = _frustum(m, pid, dst_t, K, bx)
    p_ok = (vals >= 0) & vis
    pred_oct = predict_octave(dist3, m.mp_max_dist[pid], scale_factors[1], L)
    xy = m.kf_xy[dst]
    du = xy[None, :, 0] - u[:, None]
    dv = xy[None, :, 1] - v[:, None]
    win = window_mult * scale_factors[pred_oct.clamp(0, L - 1)]
    octf = m.kf_octave[dst]
    pair = ((du.abs() < win[:, None]) & (dv.abs() < win[:, None])
            & (octf[None, :] >= (pred_oct - 1)[:, None]) & (octf[None, :] <= pred_oct[:, None])
            & ((du * du + dv * dv) * inv_sigma2_by_oct[octf.clamp(0, L - 1)][None, :]
               <= cfg.mapping.chi2_mono))
    dist = hamming.masked_distance_matrix(m.mp_desc[pid], m.kf_desc[dst], p_ok,
                                          m.kf_feat_valid[dst], pair)
    fidx, best, _ = hamming.best_and_second(dist)
    ok = (best <= cfg.matcher.th_low) & p_ok
    ok &= matcher.column_unique_best(fidx, best, ok, m.n_feat)
    f = fidx.clamp(min=0)
    q = m.kf_obs[dst, f]
    p = pid.to(torch.int32)

    add = ok & (q < 0)
    kf_obs = m.kf_obs.clone()
    kf_obs[dst] = put(m.kf_obs[dst], torch.where(add, f, m.n_feat), torch.where(add, p, -1))
    n_obs = put(m.mp_n_obs, torch.where(add, p, m.max_mp), 1, "add")
    mp_valid = m.mp_valid
    merge = ok & (q >= 0) & (q != p) & mp_valid[q.clamp(min=0)]
    qs = q.clamp(min=0)
    p_wins = torch.ones_like(merge) if prefer_src else n_obs[p] >= n_obs[qs]
    winner = torch.where(p_wins, p, qs)
    loser = torch.where(p_wins, qs, p)
    Mx = m.max_mp
    # a point dst sees at two features can lose twice: the later feature's
    # winner takes its slot, as in the JAX package
    r = put_last(torch.arange(Mx, dtype=torch.int32, device=m.device),
                 torch.where(merge, loser, Mx), torch.where(merge, winner, -1))
    r = r[r.long()]
    kf_obs = torch.where(kf_obs >= 0, r[kf_obs.clamp(min=0)], kf_obs)
    lw = torch.where(merge, winner, Mx)
    return m.replace(
        kf_obs=kf_obs,
        mp_valid=put(mp_valid, torch.where(merge, loser, Mx), False),
        mp_found=put(m.mp_found, lw, torch.where(merge, m.mp_found[loser], 0), "add"),
        mp_visible=put(m.mp_visible, lw, torch.where(merge, m.mp_visible[loser], 0), "add"),
        mp_n_obs=put(n_obs, lw, torch.where(merge, n_obs[loser], 0), "add"),
    )


def _first_index(keys, ok, size: int) -> torch.Tensor:
    """For each position i: is it the first ok position holding keys[i]?"""
    n = keys.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=keys.device)
    first = put(torch.full((size + 1,), n, dtype=torch.int32, device=keys.device),
                torch.where(ok, keys, size), ar, "min")
    return first[keys.clamp(min=0).long()] == ar


def fuse_in_neighbors(m: SlamMap, kf1: int, neighbors, neigh_ok, K, scale_factors, sigma2,
                      cfg: SlamConfig, max_targets: int = 20) -> SlamMap:
    """LocalMapping::SearchInNeighbors (src/LocalMapping.cc:507-588): fuse
    kf1's points into its 1st + 2nd covisibility neighbors (the match half
    batched over all targets, the Replace updates in covisibility order),
    then the neighbors' points back into kf1."""
    dev = m.device
    inv_s2 = 1.0 / sigma2
    W = covisibility_matrix(m)
    sec_vals, sec_idx = topk(W[neighbors.clamp(min=0)], min(5, m.max_kf))
    targets = torch.cat([neighbors, sec_idx.reshape(-1)])
    t_ok = torch.cat([neigh_ok, (sec_vals > 0).reshape(-1) & neigh_ok.repeat_interleave(sec_vals.shape[1])])
    t_ok &= (targets != kf1) & m.kf_valid[targets.clamp(min=0)]
    t_ok &= _first_index(torch.where(t_ok, targets, -1), t_ok, m.max_kf)
    rank = torch.where(t_ok, W[kf1][targets.clamp(min=0)] + 1, -1)
    tvals, tsel = topk(rank, min(max_targets, rank.shape[0]))
    targets = targets[tsel].clamp(min=0)
    t_ok = (tvals > 0) & t_ok[tsel]

    Mx, Nf = m.max_mp, m.n_feat
    pid0 = m.kf_obs[kf1].clamp(min=0)
    p_has0 = (m.kf_obs[kf1] >= 0) & m.kf_feat_valid[kf1]
    p_has0 &= _first_index(pid0, p_has0, Mx)
    ok_s, f_s = _fuse_match_in_kfs(m, pid0, p_has0, targets, K, scale_factors, inv_s2, cfg, 3.0)

    # ordered Replace scan (JAX: lax.scan over targets, local_mapping.py:495-548)
    kf_obs, mp_valid, n_obs = m.kf_obs.clone(), m.mp_valid, m.mp_n_obs
    found, visible = m.mp_found, m.mp_visible
    r_cum = torch.arange(Mx, dtype=torch.int32, device=dev)
    for t in range(targets.shape[0]):
        dst, f = targets[t], f_s[t]
        pid = r_cum[pid0]
        ok = ok_s[t] & t_ok[t] & p_has0 & mp_valid[pid.long()] & _first_index(pid, p_has0, Mx)
        q = kf_obs[dst, f]
        add = ok & (q < 0)
        kf_obs[dst] = put(kf_obs[dst], torch.where(add, f, Nf), torch.where(add, pid, -1))
        n_obs = put(n_obs, torch.where(add, pid, Mx), 1, "add")
        merge = ok & (q >= 0) & (q != pid) & mp_valid[q.clamp(min=0)]
        qs = q.clamp(min=0)
        p_wins = n_obs[pid.long()] >= n_obs[qs]
        winner = torch.where(p_wins, pid, qs)
        loser = torch.where(p_wins, qs, pid)
        r = put(torch.arange(Mx, dtype=torch.int32, device=dev),
                torch.where(merge, loser, Mx), torch.where(merge, winner, -1))
        r = r[r.long()]
        kf_obs = torch.where(kf_obs >= 0, r[kf_obs.clamp(min=0)], kf_obs)
        mp_valid = put(mp_valid, torch.where(merge, loser, Mx), False)
        lw = torch.where(merge, winner, Mx)
        lo = loser.long()
        found = put(found, lw, torch.where(merge, found[lo], 0), "add")
        visible = put(visible, lw, torch.where(merge, visible[lo], 0), "add")
        n_obs = put(n_obs, lw, torch.where(merge, n_obs[lo], 0), "add")
        r_cum = r[r_cum.long()]
    m = m.replace(kf_obs=kf_obs, mp_valid=mp_valid, mp_n_obs=n_obs, mp_found=found,
                  mp_visible=visible)

    tmask = put(torch.zeros(m.max_kf, dtype=torch.bool, device=dev),
                torch.where(t_ok, targets, m.max_kf), True)
    flat = torch.where(tmask[:, None], m.kf_obs, -1).reshape(-1)
    cand = put(torch.zeros(Mx, dtype=torch.bool, device=dev), torch.where(flat >= 0, flat, Mx), True)
    m = _fuse_points_into_kf(m, cand, kf1, K, scale_factors, inv_s2, cfg,
                             max_points=cfg.capacity.local_ba_points)
    return mt.rebuild_observation_lists(m)


def invalidate_points(m: SlamMap, bad, rebuild: bool = True) -> SlamMap:
    """MapPoint::SetBadFlag (src/MapPoint.cc:157-181) for a mask of points."""
    mp_valid = m.mp_valid & ~bad
    kf_obs = torch.where((m.kf_obs >= 0) & ~mp_valid[m.kf_obs.clamp(min=0)], -1, m.kf_obs)
    m = m.replace(mp_valid=mp_valid, kf_obs=kf_obs)
    return mt.rebuild_observation_lists(m) if rebuild else m


def cull_map_points(m: SlamMap, current_kf: int, cfg: SlamConfig) -> SlamMap:
    """LocalMapping::MapPointCulling (src/LocalMapping.cc:184-219) on recent
    points (age <= 3 keyframes)."""
    age = current_kf - m.mp_first_kf
    found_ratio = m.mp_found.float() / torch.clamp(m.mp_visible.float(), min=1.0)
    bad = (found_ratio < cfg.mapping.culling_found_ratio) & (age <= 3)
    bad |= (age >= 2) & (age <= 3) & (m.mp_n_obs <= cfg.mapping.culling_min_obs - 1)
    return invalidate_points(m, bad & m.mp_valid, rebuild=False)


def invalidate_keyframe(m: SlamMap, kf_id: int, rebuild: bool = True) -> SlamMap:
    """KeyFrame::SetBadFlag (src/KeyFrame.cc:460-552); children re-parent by
    max covisibility among lower-id siblings and the grandparent."""
    if kf_id < 0:
        return mt.rebuild_observation_lists(m) if rebuild else m
    k = kf_id
    dev = m.device
    kf_valid = m.kf_valid.clone()
    kf_valid[k] = False
    parent = int(m.kf_parent[k])
    children = (m.kf_parent == k) & m.kf_valid
    ids = torch.arange(m.max_kf, device=dev)
    W = covisibility_matrix(m)
    w_sib = torch.where(children[None, :] & (ids[None, :] < ids[:, None]), W, -1)
    best_sib = torch.argmax(w_sib, 1).to(torch.int32)
    best_w = w_sib.amax(1)
    if parent >= 0 and bool(m.kf_valid[parent]):
        w_par = W[:, parent]
    else:
        w_par = torch.zeros_like(W[:, 0])
    adopt = torch.where(best_w > w_par, best_sib, parent)
    kf_obs = m.kf_obs.clone()
    kf_obs[k] = -1
    m = m.replace(kf_valid=kf_valid, kf_parent=torch.where(children, adopt, m.kf_parent),
                  kf_obs=kf_obs)
    return mt.rebuild_observation_lists(m) if rebuild else m


def cull_keyframes(m: SlamMap, center_kf: int, cfg: SlamConfig) -> SlamMap:
    """LocalMapping::KeyFrameCulling (src/LocalMapping.cc:686-752): cull at
    most one covisible keyframe whose points are >= 90% seen by >= 3 other
    keyframes at the same or finer scale; keyframe 0 is never culled."""
    K_, N = m.kf_obs.shape
    dev = m.device
    kf, ft = m.mp_obs_kf.clamp(min=0), m.mp_obs_feat.clamp(min=0)
    obs_ok = ((m.mp_obs_kf >= 0)
              & (torch.arange(m.max_obs, device=dev)[None, :] < m.mp_n_obs[:, None])
              & (m.kf_obs[kf, ft] == torch.arange(m.max_mp, device=dev)[:, None]))
    obs_oct = torch.where(obs_ok, m.kf_octave[kf, ft], 127)
    W = covisibility_matrix(m)
    ids = torch.arange(K_, device=dev)
    cand_w = torch.where((W[center_kf] > 0) & m.kf_valid & (ids != 0) & (ids != center_kf),
                         W[center_kf], 0)
    cw, cand_idx = topk(cand_w, min(32, K_))
    obs = m.kf_obs[cand_idx]                                    # (C, N)
    mp = obs.clamp(min=0)
    has = (obs >= 0) & m.kf_feat_valid[cand_idx] & m.mp_valid[mp]
    oct_p = obs_oct[mp]                                         # (C, N, O)
    other = m.mp_obs_kf[mp] != cand_idx[:, None, None]
    fine = oct_p <= (m.kf_octave[cand_idx][..., None] + 1)
    n_better = (other & fine & (oct_p < 127)).sum(-1)
    redundant = has & (n_better >= cfg.mapping.kf_culling_min_obs)
    counts = has.sum(1)
    ratios = redundant.sum(1) / torch.clamp(counts, min=1)
    cullable = (cw > 0) & (ratios > cfg.mapping.kf_culling_redundancy) & (counts > 0)
    first = int(torch.argmax(cullable.to(torch.int32)))
    victim = int(cand_idx[first]) if bool(cullable[first]) else -1
    return invalidate_keyframe(m, victim, rebuild=False)


def mapping_pre(m: SlamMap, new_kf: int, K, scale_factors, sigma2, inv_sigma2, cfg: SlamConfig,
                n_neighbors: int | None = None, run_ba: bool = True, run_culling: bool = True):
    """Structure half of the local-mapping pass (LocalMapping::Run up to the
    BA, src/LocalMapping.cc:50-84): point culling -> triangulation with the
    top covisible neighbors -> neighbor fuse (kernel B) -> statistics refresh
    -> BA problem extraction. Returns (m, prob, cam_ids, point_ids); the BA
    triple is None with run_ba=False. The staged pass stops issuing BA
    chunks between this call and mapping_finish (mbAbortBA,
    src/LocalMapping.cc:127)."""
    if n_neighbors is None:
        n_neighbors = cfg.mapping.triangulation_neighbors
    if run_culling:
        m = cull_map_points(m, new_kf, cfg)
    vals, idx = topk(covisibility_matrix(m)[new_kf], min(n_neighbors, m.max_kf))
    m = triangulate_with_neighbors(m, new_kf, idx, vals > 0, K, scale_factors, sigma2, cfg)
    m = fuse_in_neighbors(m, new_kf, idx, vals > 0, K, scale_factors, sigma2, cfg)

    # stats refresh of everything the new keyframe or a covisible one observes
    # (the covisibility row is taken AFTER the fuse: Replace winners move)
    sel_kf = (covisibility_matrix(m)[new_kf] > 0) | (torch.arange(m.max_kf, device=m.device) == new_kf)
    flat = torch.where((sel_kf & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    touched = put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device),
                  torch.where(flat >= 0, flat, m.max_mp), True)
    m = refresh_point_stats_touched(m, scale_factors, touched)
    if not run_ba:
        return m, None, None, None
    prob, cam_ids, point_ids = extract_local_ba(
        m, new_kf, K, inv_sigma2, window=cfg.capacity.local_ba_window,
        n_fixed=cfg.capacity.local_ba_window, max_points=cfg.capacity.local_ba_points,
        bf=cfg.camera.baseline_times_fx,
    )
    return m, prob, cam_ids, point_ids


def mapping_finish(m: SlamMap, new_kf: int, res, prob, cam_ids, point_ids, cfg: SlamConfig,
                   run_culling: bool = True) -> SlamMap:
    """Write-back half of the pass (src/LocalMapping.cc:84-118): BA
    write-back (skipped when res is None, the pass aborted before its BA)
    -> keyframe culling -> one observation-list rebuild."""
    if res is not None:
        m = write_back_ba(m, res, prob, cam_ids, point_ids, rebuild=False)
    if run_culling:
        m = cull_keyframes(m, new_kf, cfg)
    return mt.rebuild_observation_lists(m)


def mapping_step(m: SlamMap, new_kf: int, K, scale_factors, sigma2, inv_sigma2,
                 cfg: SlamConfig, n_neighbors: int | None = None, run_ba: bool = True,
                 run_culling: bool = True) -> SlamMap:
    """One local-mapping pass for a new keyframe (LocalMapping::Run,
    src/LocalMapping.cc:50-118) in one call: mapping_pre, the whole local BA
    (solve_ba), mapping_finish. The staged pass computes the same thing in
    pieces that can be abandoned."""
    m, prob, cam_ids, point_ids = mapping_pre(m, new_kf, K, scale_factors, sigma2, inv_sigma2,
                                              cfg, n_neighbors, run_ba, run_culling)
    res = solve_ba(prob, cfg.optim.local_ba_iters1, cfg.optim.local_ba_iters2) if run_ba else None
    return mapping_finish(m, new_kf, res, prob, cam_ids, point_ids, cfg, run_culling)
