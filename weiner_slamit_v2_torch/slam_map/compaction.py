"""Map compaction: the valid keyframes and points re-packed to the front of
their pools (port of weiner_slamit_v2_tpu/slam_map/compaction.py).

Slot ids are never reused, so a long session fills the keyframe pool even
though culling keeps few keyframes valid. Compaction renumbers the
survivors in order, so that allocation can go on; ``System.compact``
remaps what refers to the old slots (reference keyframe, tracked
observations, trajectory anchors, BoW rows). One gather per pool field, no
host read.
"""

from __future__ import annotations

import torch

from .types import SlamMap


def compact_map(m: SlamMap) -> tuple[SlamMap, torch.Tensor, torch.Tensor]:
    """Returns (compacted map, kf_map (K,), mp_map (M,)): kf_map[old] is the
    new keyframe id (-1 if it was not valid), mp_map likewise for points."""
    dev = m.device

    def renumber(valid):
        new = torch.where(valid, torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1, -1)
        n = valid.shape[0]
        # new slot i holds old slot order[i]: valid first, each group in order
        order = torch.argsort(torch.where(valid, 0, 1) * n + torch.arange(n, device=dev), stable=True)
        return new, order

    kf_map, kf_order = renumber(m.kf_valid)
    mp_map, mp_order = renumber(m.mp_valid)

    def remap(ids, table):
        return torch.where(ids >= 0, table[ids.clamp(min=0)], -1)

    gk = lambda a: a[kf_order]  # noqa: E731
    gp = lambda a: a[mp_order]  # noqa: E731
    m2 = m.replace(
        kf_pose=gk(m.kf_pose), kf_valid=gk(m.kf_valid), kf_frame_id=gk(m.kf_frame_id),
        kf_timestamp=gk(m.kf_timestamp), kf_parent=remap(gk(m.kf_parent), kf_map),
        kf_xy=gk(m.kf_xy), kf_octave=gk(m.kf_octave), kf_angle=gk(m.kf_angle),
        kf_desc=gk(m.kf_desc), kf_feat_valid=gk(m.kf_feat_valid),
        kf_obs=remap(gk(m.kf_obs), mp_map), kf_ur=gk(m.kf_ur),
        mp_pos=gp(m.mp_pos), mp_valid=gp(m.mp_valid), mp_desc=gp(m.mp_desc),
        mp_normal=gp(m.mp_normal), mp_min_dist=gp(m.mp_min_dist), mp_max_dist=gp(m.mp_max_dist),
        mp_first_kf=remap(gp(m.mp_first_kf), kf_map), mp_visible=gp(m.mp_visible),
        mp_found=gp(m.mp_found), mp_obs_kf=remap(gp(m.mp_obs_kf), kf_map),
        mp_obs_feat=gp(m.mp_obs_feat), mp_n_obs=gp(m.mp_n_obs),
        n_kf=m.kf_valid.sum(dtype=torch.int32), n_mp=m.mp_valid.sum(dtype=torch.int32),
    )
    return m2, kf_map, mp_map
