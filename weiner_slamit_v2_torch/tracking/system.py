"""System facade: the public entry point (port of
weiner_slamit_v2_tpu/tracking/system.py, the monocular slice;
ORB_SLAM2::System, src/System.cc).

``track_monocular`` runs tracking and, after each new keyframe, one local
mapping pass (``mapping_step``). As in the JAX package, tracking keeps
using the pre-pass map until the pass is adopted ``mapping_latency_frames``
frames later (the reference's asynchronous LocalMapping thread); the pass
itself runs when the keyframe is created, on the same device.

Not ported in this slice: the fused N-frame scan (``frames_per_sync > 1``,
ROADMAP A.7), the staged abortable BA (``abortable_ba=True``, ROADMAP A.8),
loop closing (ROADMAP A.11), map lifecycle (ROADMAP A.12) and distributed
BA (ROADMAP A.13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..geometry.camera import Camera
from ..io import trajectory as traj_io
from ..util import resolve_device
from .local_mapping import mapping_step
from .tracker import Tracker, TrackerOutput


class System:
    def __init__(self, cfg: Optional[SlamConfig] = None, camera: Optional[Camera] = None,
                 device=None, enable_mapping: bool = True, enable_loop_closing: bool = False,
                 mapping_neighbors: int | None = None):
        self.cfg = cfg or SlamConfig()
        if self.cfg.tracking.abortable_ba:
            raise NotImplementedError(
                "abortable_ba=True (staged mapping_pre / BA chunks / mapping_finish) is "
                "not ported: ROADMAP A.8; use TrackingConfig(abortable_ba=False)")
        if enable_loop_closing:
            raise NotImplementedError("loop closing is not ported: ROADMAP A.11")
        cc = self.cfg.camera
        self.camera = camera or Camera.create(cc.fx, cc.fy, cc.cx, cc.cy, cc.k1, cc.k2,
                                              cc.p1, cc.p2, cc.k3, cc.width, cc.height)
        self.device = resolve_device(device)
        self.tracker = Tracker(self.cfg, self.camera, self.device)
        self.enable_mapping = enable_mapping
        self.mapping_neighbors = (mapping_neighbors if mapping_neighbors is not None
                                  else self.cfg.mapping.triangulation_neighbors)
        if enable_mapping:
            self.tracker.mapping_hook = self._on_new_keyframe
            self.tracker.mapper_idle_hook = self.mapper_idle
        # the mapping pass waiting for adoption: (map, kf_id, counter snapshot)
        self._pending_map = None
        self._pending_kf = -1
        self._pending_counters = None
        self._mapping_enqueued_frame = -(10**9)
        self.mapping_passes = 0   # adopted passes

    def _on_new_keyframe(self, kf_id: int) -> None:
        t = self.tracker
        self._pending_map = mapping_step(
            t.m, kf_id, t.K, t.scale_factors, t.sigma2, t.inv_sigma2, self.cfg,
            n_neighbors=self.mapping_neighbors,
        )
        self._pending_kf = kf_id
        # tracking keeps counting visible/found while the pass waits; adoption
        # re-applies those increments (they feed the found-ratio culling)
        self._pending_counters = (t.m.mp_visible, t.m.mp_found)
        self._mapping_enqueued_frame = t.frame_id

    def mapper_idle(self, force: bool = False) -> bool:
        """Adopt a finished mapping pass once its latency floor has passed
        (or now, with force); True when no pass is waiting."""
        if self._pending_map is None:
            return True
        busy = self.tracker.frame_id - self._mapping_enqueued_frame
        if not force and busy < self.cfg.tracking.mapping_latency_frames:
            return False
        t = self.tracker
        m, kf_id = self._pending_map, self._pending_kf
        snap_v, snap_f = self._pending_counters
        self._pending_map, self._pending_kf, self._pending_counters = None, -1, None
        m = m.replace(mp_visible=m.mp_visible + (t.m.mp_visible - snap_v),
                      mp_found=m.mp_found + (t.m.mp_found - snap_f))
        prev_kf_valid = t.m.kf_valid
        t.m = m
        self.mapping_passes += 1
        self._reanchor_culled_trajectory(prev_kf_valid)
        if t.ref_kf == kf_id and t.last_kf_frame == t.frame_id:
            t.last_Tcw = t.m.kf_pose[kf_id]
        return True

    def _reanchor_culled_trajectory(self, prev_kf_valid) -> None:
        """Re-anchor trajectory entries whose reference keyframe the adopted
        pass culled onto the first surviving spanning-tree ancestor (the mTcp
        mechanism of KeyFrame::SetBadFlag, src/KeyFrame.cc:460-552); the
        exported pose is unchanged by the re-anchoring."""
        t = self.tracker
        if not t.trajectory:
            return
        m = t.m
        culled = torch.nonzero(prev_kf_valid & ~m.kf_valid).flatten().tolist()
        if not culled:
            return
        valid_np = m.kf_valid.cpu().numpy()
        parent_np = m.kf_parent.cpu().numpy()
        for c in culled:
            p = int(parent_np[c])
            hops = 0
            while p >= 0 and not valid_np[p] and hops < len(parent_np):
                p = int(parent_np[p])
                hops += 1
            if p >= 0 and valid_np[p]:
                T_cp, new_ref = m.kf_pose[c] @ se3.inv(m.kf_pose[p]), p
            else:
                T_cp, new_ref = m.kf_pose[c], -1
            for i, (ts, T_cr, ref) in enumerate(t.trajectory):
                if ref == c:
                    t.trajectory[i] = (ts, T_cr @ T_cp, new_ref)
            if t.ref_kf == c and new_ref >= 0:
                t.ref_kf = new_ref

    def finish(self) -> None:
        """Adopt any waiting mapping pass (System::Shutdown analogue)."""
        self.mapper_idle(force=True)

    def track_monocular(self, image: np.ndarray, timestamp: float) -> TrackerOutput:
        """Per-frame entry (System::TrackMonocular, src/System.cc:307-361).
        image: (H, W) grayscale, uint8 or float."""
        self.mapper_idle()
        img = image if getattr(image, "dtype", None) == np.uint8 else np.asarray(image, np.float32)
        return self.tracker.process_frame(img, timestamp)

    @property
    def map(self):
        self.finish()
        return self.tracker.m

    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    def n_map_points(self) -> int:
        return int(self.map.mp_valid.sum())

    def save_trajectory_tum(self, path: str) -> None:
        self.finish()
        ts, Twc = self.tracker.trajectory_Twc()
        traj_io.save_tum(path, ts, Twc)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """Keyframe-only export (SaveKeyFrameTrajectoryTUM, src/System.cc:457-491)."""
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        Tcw = m.kf_pose.double().cpu().numpy()[valid]
        traj_io.save_tum(path, m.kf_timestamp.cpu().numpy()[valid], np.linalg.inv(Tcw))
