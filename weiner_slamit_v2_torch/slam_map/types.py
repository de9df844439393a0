"""The map as structure-of-arrays (port of
weiner_slamit_v2_tpu/slam_map/types.py; KeyFrame / MapPoint / Map of
src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc).

``SlamMap`` is a dataclass of tensors with the JAX package's field names,
capacities and dtypes, except descriptors: int32 bit patterns of the
reference's uint32 words. Updates return a new ``SlamMap`` (fields that did
not change are shared, not copied).

Conventions: keyframe id == slot in kf_*; map-point id == slot in mp_*;
``kf_obs[k, f]`` is the map point seen by feature f of keyframe k or -1;
``mp_obs_kf/mp_obs_feat`` list each point's observations (MapPoint::
mObservations, capped at O).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import MapCapacityConfig
from ..util import put, resolve_device


@dataclass
class SlamMap:
    kf_pose: torch.Tensor       # (K, 4, 4) f32 world->camera
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) i32
    kf_timestamp: torch.Tensor  # (K,) f32
    kf_parent: torch.Tensor     # (K,) i32 spanning-tree parent (-1 = root)
    kf_xy: torch.Tensor         # (K, N, 2) f32 undistorted keypoints
    kf_octave: torch.Tensor     # (K, N) i32
    kf_angle: torch.Tensor      # (K, N) f32
    kf_desc: torch.Tensor       # (K, N, 8) i32 bit patterns
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_obs: torch.Tensor        # (K, N) i32 map-point id or -1
    kf_ur: torch.Tensor         # (K, N) f32 stereo right u (-1 = mono)
    mp_pos: torch.Tensor        # (M, 3) f32
    mp_valid: torch.Tensor      # (M,) bool
    mp_desc: torch.Tensor       # (M, 8) i32
    mp_normal: torch.Tensor     # (M, 3) f32
    mp_min_dist: torch.Tensor   # (M,) f32
    mp_max_dist: torch.Tensor   # (M,) f32
    mp_first_kf: torch.Tensor   # (M,) i32
    mp_visible: torch.Tensor    # (M,) i32
    mp_found: torch.Tensor      # (M,) i32
    mp_obs_kf: torch.Tensor     # (M, O) i32
    mp_obs_feat: torch.Tensor   # (M, O) i32
    mp_n_obs: torch.Tensor      # (M,) i32
    n_kf: torch.Tensor          # () i32 allocated keyframe slots
    n_mp: torch.Tensor          # () i32 allocated map-point slots

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_obs.shape[1]

    @property
    def max_obs(self) -> int:
        return self.mp_obs_kf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device

    def replace(self, **kw) -> "SlamMap":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SlamMap":
        """Every field on ``device`` (fields already there are shared)."""
        return SlamMap(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def empty_map(cap: MapCapacityConfig, n_features: int, device=None) -> SlamMap:
    K, M, O, N = cap.max_keyframes, cap.max_map_points, cap.max_obs_per_point, n_features
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=resolve_device(device))
    return SlamMap(
        kf_pose=torch.eye(4, dtype=f32, **kw).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, dtype=torch.bool, **kw),
        kf_frame_id=torch.full((K,), -1, dtype=i32, **kw),
        kf_timestamp=torch.zeros(K, dtype=f32, **kw),
        kf_parent=torch.full((K,), -1, dtype=i32, **kw),
        kf_xy=torch.zeros((K, N, 2), dtype=f32, **kw),
        kf_octave=torch.zeros((K, N), dtype=i32, **kw),
        kf_angle=torch.zeros((K, N), dtype=f32, **kw),
        kf_desc=torch.zeros((K, N, 8), dtype=i32, **kw),
        kf_feat_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_obs=torch.full((K, N), -1, dtype=i32, **kw),
        kf_ur=torch.full((K, N), -1.0, dtype=f32, **kw),
        mp_pos=torch.zeros((M, 3), dtype=f32, **kw),
        mp_valid=torch.zeros(M, dtype=torch.bool, **kw),
        mp_desc=torch.zeros((M, 8), dtype=i32, **kw),
        mp_normal=torch.zeros((M, 3), dtype=f32, **kw),
        mp_min_dist=torch.zeros(M, dtype=f32, **kw),
        mp_max_dist=torch.full((M,), torch.inf, dtype=f32, **kw),
        mp_first_kf=torch.full((M,), -1, dtype=i32, **kw),
        mp_visible=torch.ones(M, dtype=i32, **kw),
        mp_found=torch.ones(M, dtype=i32, **kw),
        mp_obs_kf=torch.full((M, O), -1, dtype=i32, **kw),
        mp_obs_feat=torch.full((M, O), -1, dtype=i32, **kw),
        mp_n_obs=torch.zeros(M, dtype=i32, **kw),
        n_kf=torch.tensor(0, dtype=i32, **kw),
        n_mp=torch.tensor(0, dtype=i32, **kw),
    )


def add_keyframe(m: SlamMap, pose, xy_und, octave, angle, desc, feat_valid, obs,
                 frame_id: int, timestamp: float, parent: int, ur=None):
    """Freeze a frame into slot n_kf (Tracking::CreateNewKeyFrame,
    src/Tracking.cc:1312) and register its observations. Returns (map,
    kf_id); a full pool leaves the map unchanged and returns -1."""
    k = int(m.n_kf)
    if k >= m.max_kf:
        return m, -1
    if ur is None:
        ur = torch.full(obs.shape, -1.0, device=m.device)
    obs = torch.where(feat_valid, obs, -1)

    def row(arr, val):
        arr = arr.clone()
        arr[k] = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        return arr

    m2 = m.replace(
        kf_pose=row(m.kf_pose, pose), kf_valid=row(m.kf_valid, True),
        kf_frame_id=row(m.kf_frame_id, frame_id), kf_timestamp=row(m.kf_timestamp, timestamp),
        kf_parent=row(m.kf_parent, parent), kf_xy=row(m.kf_xy, xy_und),
        kf_octave=row(m.kf_octave, octave), kf_angle=row(m.kf_angle, angle),
        kf_desc=row(m.kf_desc, desc), kf_feat_valid=row(m.kf_feat_valid, feat_valid),
        kf_obs=row(m.kf_obs, obs), kf_ur=row(m.kf_ur, ur), n_kf=m.n_kf + 1,
    )
    return _add_observations_for_kf(m2, k, obs), k


def _add_observations_for_kf(m: SlamMap, kf_id: int, obs: torch.Tensor) -> SlamMap:
    """Append (kf_id, feat) to each observed map point's observation list."""
    feat = torch.arange(obs.shape[0], dtype=torch.int32, device=obs.device)
    has = obs >= 0
    mp = torch.where(has, obs, 0)
    slot = torch.where(has, m.mp_n_obs[mp], m.max_obs)
    w = has & (slot < m.max_obs)
    mp_w = torch.where(w, mp, m.max_mp)
    slot_w = torch.where(w, slot, m.max_obs)
    return m.replace(
        mp_obs_kf=put(m.mp_obs_kf, (mp_w, slot_w), kf_id),
        mp_obs_feat=put(m.mp_obs_feat, (mp_w, slot_w), feat),
        mp_n_obs=put(m.mp_n_obs, mp_w, 1, "add"),
    )


def add_map_points(m: SlamMap, pos, desc, normal, min_dist, max_dist, kf1, feat1,
                   kf2, feat2, valid):
    """Batch-insert points with their two observations
    (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:441-455).
    Returns (map, ids (B,) or -1)."""
    B = pos.shape[0]
    ids = m.n_mp + torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    fits = valid & (ids < m.max_mp)
    idw = torch.where(fits, ids, m.max_mp)
    ones = torch.ones(B, dtype=torch.int32, device=m.device)
    m2 = m.replace(
        mp_pos=put(m.mp_pos, idw, pos), mp_desc=put(m.mp_desc, idw, desc),
        mp_normal=put(m.mp_normal, idw, normal), mp_min_dist=put(m.mp_min_dist, idw, min_dist),
        mp_max_dist=put(m.mp_max_dist, idw, max_dist), mp_first_kf=put(m.mp_first_kf, idw, kf1),
        mp_valid=put(m.mp_valid, idw, True), mp_visible=put(m.mp_visible, idw, ones),
        mp_found=put(m.mp_found, idw, ones), mp_n_obs=put(m.mp_n_obs, idw, 0),
        n_mp=m.n_mp + fits.sum(dtype=torch.int32),
    )

    def put_obs(mm, kfs, feats, slot):
        has = fits & (kfs >= 0)
        idx = torch.where(has, idw, m.max_mp)
        kf_w = torch.where(has, kfs, mm.max_kf)
        return mm.replace(
            mp_obs_kf=put(mm.mp_obs_kf, (idx, slot), kfs),
            mp_obs_feat=put(mm.mp_obs_feat, (idx, slot), feats),
            mp_n_obs=put(mm.mp_n_obs, idx, 1, "add"),
            kf_obs=put(mm.kf_obs, (kf_w, feats), idw),
        )

    m2 = put_obs(m2, kf1, feat1, 0)
    m2 = put_obs(m2, kf2, feat2, 1)
    return m2, torch.where(fits, ids, -1)


def observation_indicator(m: SlamMap) -> torch.Tensor:
    """(K, M) bool: keyframe k observes map point p (from kf_obs)."""
    K, N = m.kf_obs.shape
    has = (m.kf_obs >= 0) & m.kf_feat_valid
    rows = torch.arange(K, device=m.device)[:, None].expand(K, N)
    cols = torch.where(has, m.kf_obs, m.max_mp)
    return put(torch.zeros((K, m.max_mp), dtype=torch.bool, device=m.device), (rows, cols), True)


def rebuild_observation_lists(m: SlamMap) -> SlamMap:
    """Reconstruct mp_obs_kf/mp_obs_feat/mp_n_obs from kf_obs (the ground
    truth relation) with one stable sort (MapPoint::EraseObservation
    bookkeeping, src/MapPoint.cc:104-143)."""
    K, N = m.kf_obs.shape
    Mx, O = m.max_mp, m.max_obs
    dev = m.device
    flat = m.kf_obs.reshape(-1)
    has = (flat >= 0) & m.kf_feat_valid.reshape(-1) & m.kf_valid.repeat_interleave(N)
    key = torch.where(has, flat, Mx)
    sorted_mp, order = torch.sort(key, stable=True)
    flat_kf = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(N)[order]
    flat_ft = torch.arange(N, dtype=torch.int32, device=dev).repeat(K)[order]
    first = torch.searchsorted(sorted_mp, torch.arange(Mx, dtype=sorted_mp.dtype, device=dev))
    rank = torch.arange(K * N, device=dev) - first[sorted_mp.clamp(0, Mx - 1)]
    ok = (sorted_mp < Mx) & (rank < O)
    mp_w = torch.where(ok, sorted_mp, Mx)
    rk_w = torch.where(ok, rank, O)
    full = lambda: torch.full((Mx, O), -1, dtype=torch.int32, device=dev)  # noqa: E731
    return m.replace(
        mp_obs_kf=put(full(), (mp_w, rk_w), flat_kf),
        mp_obs_feat=put(full(), (mp_w, rk_w), flat_ft),
        mp_n_obs=put(torch.zeros(Mx, dtype=torch.int32, device=dev), mp_w, 1, "add"),
    )
