"""Batched map-point statistics (port of
weiner_slamit_v2_tpu/slam_map/point_stats.py): distinctive descriptor
(MapPoint::ComputeDistinctiveDescriptors, src/MapPoint.cc:248-313), mean
viewing normal and scale band (UpdateNormalAndDepth, src/MapPoint.cc:336-377).
"""

from __future__ import annotations

import torch

from ..ops import hamming
from ..util import put, topk
from .types import SlamMap


def _stats(m: SlamMap, pids: torch.Tensor, scale_factors: torch.Tensor):
    """Stats for points ``pids``: (new_desc, normal, min_dist, max_dist, cnt)."""
    O = m.max_obs
    T = pids.shape[0]
    obs_kf, obs_ft, n_obs = m.mp_obs_kf[pids], m.mp_obs_feat[pids], m.mp_n_obs[pids]
    obs_ok = (obs_kf >= 0) & (torch.arange(O, device=m.device)[None, :] < n_obs[:, None])
    kf, ft = obs_kf.clamp(min=0), obs_ft.clamp(min=0)
    obs_ok &= (m.kf_obs[kf, ft] == pids[:, None]) & m.kf_valid[kf]

    descs = m.kf_desc[kf, ft]                                   # (T, O, 8)
    d = hamming.distance_matrix(descs, descs)                   # (T, O, O)
    d = torch.where(obs_ok[:, :, None] & obs_ok[:, None, :], d, hamming.INVALID_DIST)
    d_sorted = torch.sort(d, dim=2).values
    cnt = obs_ok.sum(1, dtype=torch.int32)
    med_idx = (cnt // 2).clamp(min=0).long()
    median = d_sorted.gather(2, med_idx[:, None, None].expand(T, O, 1))[..., 0]
    median = torch.where(obs_ok, median, hamming.INVALID_DIST)
    aT = torch.arange(T, device=m.device)
    new_desc = descs[aT, torch.argmin(median, 1)]

    pose = m.kf_pose[kf]
    centers = -(pose[..., :3, :3].transpose(-1, -2) @ pose[..., :3, 3:4])[..., 0]
    rays = m.mp_pos[pids][:, None, :] - centers
    norms = torch.linalg.norm(rays, dim=-1)
    rays_n = rays / torch.clamp(norms, min=1e-9)[..., None]
    w = obs_ok.float()
    normal = (rays_n * w[..., None]).sum(1) / torch.clamp(w.sum(1), min=1.0)[:, None]

    # scale band from the first-listed valid observation (MapPoint.cc:358-374)
    ref_slot = torch.argmax(obs_ok.to(torch.int32), 1)
    L = scale_factors.shape[0]
    ref_oct = m.kf_octave[kf[aT, ref_slot], ft[aT, ref_slot]]
    max_dist = norms[aT, ref_slot] * scale_factors[ref_oct.clamp(0, L - 1)]
    min_dist = max_dist / scale_factors[L - 1]
    return new_desc, normal, min_dist, max_dist, cnt


def refresh_point_stats(m: SlamMap, scale_factors: torch.Tensor) -> SlamMap:
    """Recompute descriptor / normal / scale band / n_obs of every valid point."""
    pids = torch.arange(m.max_mp, device=m.device)
    desc, normal, min_d, max_d, cnt = _stats(m, pids, scale_factors)
    upd = m.mp_valid & (cnt > 0)
    return m.replace(
        mp_desc=torch.where(upd[:, None], desc, m.mp_desc),
        mp_normal=torch.where(upd[:, None], normal, m.mp_normal),
        mp_max_dist=torch.where(upd, max_d, m.mp_max_dist),
        mp_min_dist=torch.where(upd, min_d, m.mp_min_dist),
        mp_n_obs=torch.where(m.mp_valid, cnt, m.mp_n_obs),
    )


def refresh_point_stats_touched(m: SlamMap, scale_factors, touched, cap: int = 4096) -> SlamMap:
    """refresh_point_stats restricted to the top-``cap`` touched points
    (the reference likewise updates only affected MapPoints)."""
    sel_v, pids = topk((touched & m.mp_valid).to(torch.int32), min(cap, m.max_mp))
    sel = sel_v > 0
    desc, normal, min_d, max_d, cnt = _stats(m, pids, scale_factors)
    upd = sel & (cnt > 0)
    w_idx = torch.where(upd, pids, m.max_mp)
    w_cnt = torch.where(sel, pids, m.max_mp)
    return m.replace(
        mp_desc=put(m.mp_desc, w_idx, desc),
        mp_normal=put(m.mp_normal, w_idx, normal),
        mp_max_dist=put(m.mp_max_dist, w_idx, max_d),
        mp_min_dist=put(m.mp_min_dist, w_idx, min_d),
        mp_n_obs=put(m.mp_n_obs, w_cnt, cnt),
    )


def predict_octave(dist, max_dist, scale_factor, n_levels: int) -> torch.Tensor:
    """Predicted pyramid level from viewing distance (MapPoint::PredictScale,
    src/MapPoint.cc:391-400)."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    if not torch.is_tensor(scale_factor):
        scale_factor = torch.full((), scale_factor, dtype=torch.float32, device=dist.device)
    log_s = torch.log(scale_factor.to(torch.float32))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_s)
    return lvl.to(torch.int32).clamp(0, n_levels - 1)

