"""Extract BA problems from the map and write results back (port of
weiner_slamit_v2_tpu/optim/ba_extract.py: the local extractor and write-back,
the graph-building and write-back halves of Optimizer::LocalBundleAdjustment,
src/Optimizer.cc:453-615, 700-760, and the full-map extractor of the global
BA after a loop closure)."""

from __future__ import annotations

import torch

from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.types import SlamMap, rebuild_observation_lists
from ..util import put, topk
from .local_ba import BAProblem, BAResult


def extract_local_ba(m: SlamMap, center_kf: int, K, inv_sigma2_by_octave,
                     window: int, n_fixed: int, max_points: int, bf: float = 0.0):
    """Local BA around ``center_kf``: cam slots [0, window) are the active
    covisible window (center first), [window, window + n_fixed) fixed
    boundary cameras. bf > 0 (stereo / RGB-D) gathers each observation's
    right-u (kf_ur, mvuRight) for the stereo rows. Returns (problem,
    cam_ids (C,), point_ids (P,))."""
    dev = m.device
    W = covisibility_matrix(m)
    vals, idx = topk(W[center_kf], window - 1)
    center = torch.tensor([center_kf], dtype=torch.int64, device=dev)
    active = torch.cat([center, torch.where(vals > 0, idx, -1)])
    is_active = put(torch.zeros(m.max_kf, dtype=torch.bool, device=dev),
                    torch.where(active >= 0, active, m.max_kf), True)

    flat = torch.where((is_active & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    in_local = put(torch.zeros(m.max_mp, dtype=torch.bool, device=dev),
                   torch.where(flat >= 0, flat, m.max_mp), True) & m.mp_valid
    pvals, point_ids = topk(torch.where(in_local, m.mp_n_obs, -1), max_points)
    p_ok = pvals >= 0
    point_ids = torch.where(p_ok, point_ids, -1)

    pid = point_ids.clamp(min=0)
    obs_kfs = m.mp_obs_kf[pid]
    obs_ok = (obs_kfs >= 0) & p_ok[:, None]
    kf_hit = put(torch.zeros(m.max_kf, dtype=torch.bool, device=dev),
                 torch.where(obs_ok, obs_kfs, m.max_kf), True)
    fixed_cand = kf_hit & m.kf_valid & ~is_active
    fvals, fidx = topk(fixed_cand.to(torch.int32), n_fixed)
    cam_ids = torch.cat([active, torch.where(fvals > 0, fidx, -1)])
    C = cam_ids.shape[0]
    kf_to_slot = put(torch.full((m.max_kf + 1,), -1, dtype=torch.int32, device=dev),
                     torch.where(cam_ids >= 0, cam_ids, m.max_kf),
                     torch.arange(C, dtype=torch.int32, device=dev))

    obs_cam = kf_to_slot[obs_kfs.clamp(0, m.max_kf - 1)]
    obs_feat = m.mp_obs_feat[pid].clamp(min=0)
    kf_safe = obs_kfs.clamp(min=0)
    backref = m.kf_obs[kf_safe, obs_feat] == pid[:, None]
    octv = m.kf_octave[kf_safe, obs_feat]
    inv_s2 = inv_sigma2_by_octave[octv.clamp(0, inv_sigma2_by_octave.shape[0] - 1)]
    obs_valid = obs_ok & (obs_cam >= 0) & backref
    ur = m.kf_ur[kf_safe, obs_feat]
    prob = BAProblem(
        cam_pose=m.kf_pose[cam_ids.clamp(min=0)],
        cam_fixed=torch.arange(C, device=dev) >= active.shape[0],
        cam_valid=cam_ids >= 0,
        points=m.mp_pos[pid],
        point_valid=p_ok,
        obs_cam=torch.where(obs_valid, obs_cam, -1),
        obs_uv=m.kf_xy[kf_safe, obs_feat],
        obs_inv_sigma2=inv_s2,
        obs_valid=obs_valid,
        K=K,
        obs_ur=ur if bf > 0 else None,
        obs_has_ur=(ur >= 0) & obs_valid if bf > 0 else None,
        bf=torch.tensor(bf, dtype=torch.float32, device=dev) if bf > 0 else None,
    )
    return prob, cam_ids, point_ids


def extract_global_ba(m: SlamMap, K, inv_sigma2_by_octave, gauge_kf: int = 0, bf: float = 0.0):
    """The full-map problem (GlobalBundleAdjustemnt [sic], Optimizer.cc:41-47):
    every keyframe and point slot, invalid ones masked, the gauge fixed at
    keyframe ``gauge_kf``. Returns (problem, cam_ids (max_kf,), point_ids
    (max_mp,))."""
    dev = m.device
    C = m.max_kf
    cam_ids = torch.where(m.kf_valid, torch.arange(C, dtype=torch.int32, device=dev), -1)
    point_ids = torch.where(m.mp_valid, torch.arange(m.max_mp, dtype=torch.int32, device=dev), -1)
    obs_kfs = m.mp_obs_kf
    obs_feat = m.mp_obs_feat.clamp(min=0)
    kf_safe = obs_kfs.clamp(min=0)
    backref = m.kf_obs[kf_safe, obs_feat] == torch.arange(m.max_mp, device=dev)[:, None]
    obs_ok = (obs_kfs >= 0) & m.mp_valid[:, None] & m.kf_valid[kf_safe] & backref
    octv = m.kf_octave[kf_safe, obs_feat]
    ur = m.kf_ur[kf_safe, obs_feat]
    prob = BAProblem(
        cam_pose=m.kf_pose,
        cam_fixed=torch.arange(C, device=dev) == gauge_kf,
        cam_valid=m.kf_valid,
        points=m.mp_pos,
        point_valid=m.mp_valid,
        obs_cam=torch.where(obs_ok, obs_kfs, -1),
        obs_uv=m.kf_xy[kf_safe, obs_feat],
        obs_inv_sigma2=inv_sigma2_by_octave[octv.clamp(0, inv_sigma2_by_octave.shape[0] - 1)],
        obs_valid=obs_ok,
        K=K,
        obs_ur=ur if bf > 0 else None,
        obs_has_ur=(ur >= 0) & obs_ok if bf > 0 else None,
        bf=torch.tensor(bf, dtype=torch.float32, device=dev) if bf > 0 else None,
    )
    return prob, cam_ids, point_ids


def write_back_ba(m: SlamMap, res: BAResult, prob: BAProblem, cam_ids, point_ids,
                  rebuild: bool = True) -> SlamMap:
    """Scatter optimized poses/points back and erase outlier observations."""
    kf_pose = put(m.kf_pose, torch.where(cam_ids >= 0, cam_ids, m.max_kf), res.cam_pose)
    mp_pos = put(m.mp_pos, torch.where(point_ids >= 0, point_ids, m.max_mp), res.points)
    m = m.replace(kf_pose=kf_pose, mp_pos=mp_pos)
    bad = prob.obs_valid & ~res.obs_inlier
    pid = point_ids.clamp(min=0)
    obs_kfs = m.mp_obs_kf[pid]
    obs_fts = m.mp_obs_feat[pid].clamp(min=0)
    kf_w = torch.where(bad & (obs_kfs >= 0), obs_kfs, m.max_kf)
    m = m.replace(kf_obs=put(m.kf_obs, (kf_w, obs_fts), -1))
    return rebuild_observation_lists(m) if rebuild else m
