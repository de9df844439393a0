"""System facade: the public entry point (port of
weiner_slamit_v2_tpu/tracking/system.py; ORB_SLAM2::System, src/System.cc).

``track_monocular``, ``track_rgbd`` and ``track_stereo`` run tracking and,
after each new keyframe, one local mapping pass. As in the JAX package, tracking keeps using the pre-pass map
until the pass is adopted ``mapping_latency_frames`` frames later (the
reference's asynchronous LocalMapping thread).

Two forms of the pass, as in the JAX package:
* ``abortable_ba=False``: ``mapping_step`` in one call at the keyframe;
* ``abortable_ba=True`` (the default): staged. ``mapping_pre`` runs at the
  keyframe; each later poll launches the next stage once the previous one is
  done on the device (``ba_phase1``, ``ba_phase2_chunk`` x ceil(iters2 /
  ba_chunk_iters), then ``ba_finalize`` + ``mapping_finish``). A forced
  keyframe insertion aborts the chunks not yet issued and adopts the best
  state so far (mbAbortBA, src/LocalMapping.cc:127). "Done on the device"
  is a ``torch.cuda.Event`` recorded after the stage's launch; on the CPU a
  stage is done when its call returns.

With ``enable_loop_closing=True`` each adopted pass is followed by the loop
closer (tracking/loop_closing.py), whose global BA runs in chunks between
frames and is adopted only while no mapping pass is in flight.

``mapping_device`` runs the mapping pass on another device: the snapshot
moves there per keyframe, the stages' readiness events are recorded there,
and the adopted map comes back to the session's device.
``distributed_gba`` runs the points-sharded global BA (parallel/) and adopts
it into the live session.

Before each frame, ``_pre_frame`` adopts a finished pass (and a finished
global BA) and, once the keyframe pool is nearly full and at least 2 slots
can be reclaimed, compacts the map (keyframe slot ids are never reused).
``save_map`` / ``load_map`` write and read the JAX package's npz checkpoint
layout.

With ``frames_per_sync > 1`` the tracker resolves its pipelined frames
(``flush_pending``) before a mapping pass or a global BA is adopted, and
before ``finish`` and every export.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..geometry.camera import Camera
from ..io import trajectory as traj_io
from ..optim.ba_extract import extract_global_ba
from ..optim.local_ba import BA_LAMBDA_INIT, ba_finalize, ba_phase1, ba_phase2_chunk
from ..slam_map import checkpoint
from ..slam_map.compaction import compact_map
from ..slam_map.point_stats import refresh_point_stats
from ..util import event_done, launched_event, resolve_device
from .local_mapping import mapping_finish, mapping_pre, mapping_step
from .loop_closing import LoopCloser, _adopt_gba
from .tracker import Tracker, TrackerOutput


def _frame(image):
    """uint8 frames stay uint8 (4x fewer bytes to the card); others float32."""
    return image if getattr(image, "dtype", None) == np.uint8 else np.asarray(image, np.float32)


class System:
    def __init__(self, cfg: Optional[SlamConfig] = None, camera: Optional[Camera] = None,
                 device=None, enable_mapping: bool = True, enable_loop_closing: bool = False,
                 mapping_neighbors: int | None = None, mapping_device=None):
        """mapping_device: run the mapping pass there (pipeline parallelism:
        the tracking device keeps the per-frame path); None = the session's
        device."""
        self.cfg = cfg or SlamConfig()
        cc = self.cfg.camera
        self.camera = camera or Camera.create(cc.fx, cc.fy, cc.cx, cc.cy, cc.k1, cc.k2,
                                              cc.p1, cc.p2, cc.k3, cc.width, cc.height)
        self.device = resolve_device(device)
        self.mapping_device = self.device if mapping_device is None else torch.device(mapping_device)
        self.tracker = Tracker(self.cfg, self.camera, self.device)
        self.loop_closer = LoopCloser(self.cfg, self.tracker) if enable_loop_closing else None
        self.enable_mapping = enable_mapping
        self.mapping_neighbors = (mapping_neighbors if mapping_neighbors is not None
                                  else self.cfg.mapping.triangulation_neighbors)
        if enable_mapping:
            self.tracker.mapping_hook = self._on_new_keyframe
            self.tracker.mapper_idle_hook = self.mapper_idle
        self.tracker.reset_hook = self._discard_pending
        self.localization_only = False
        # the mapping pass waiting for adoption: (map, its event, kf_id,
        # counter snapshot); a staged pass in flight is in _stage
        self._pending_map = None
        self._pending_event = None
        self._pending_kf = -1
        self._pending_counters = None
        self._mapping_enqueued_frame = -(10**9)
        self._stage: Optional[dict] = None
        self.mapping_passes = 0      # adopted passes
        self.staged_passes = 0       # staged passes that reached mapping_finish
        self.ba_chunks_issued = 0    # ba_phase1 + ba_phase2_chunk launches
        self.ba_chunks_aborted = 0   # the ones an abort skipped
        self.compactions = 0

    @property
    def _n_ba_chunks(self) -> int:
        per = max(self.cfg.tracking.ba_chunk_iters, 1)
        return -(-self.cfg.optim.local_ba_iters2 // per)

    def _discard_pending(self) -> None:
        """Drop the pass in flight (the tracker's reset_hook): a pass computed
        on the pre-reset map must not be adopted into the fresh session."""
        self._pending_map = self._pending_event = self._pending_counters = None
        self._pending_kf = -1
        self._stage = None
        if self.loop_closer is not None:
            self.loop_closer.discard_pending_gba()

    def _on_new_keyframe(self, kf_id: int) -> None:
        if self.localization_only:
            return
        t = self.tracker
        md = self.mapping_device
        args = (t.m.to(md), kf_id, t.K.to(md), t.scale_factors.to(md), t.sigma2.to(md),
                t.inv_sigma2.to(md), self.cfg)
        if self.cfg.tracking.abortable_ba:
            m, prob, cam_ids, point_ids = mapping_pre(*args, n_neighbors=self.mapping_neighbors)
            self._stage = dict(name="pre", kf=kf_id, m=m, prob=prob, cam_ids=cam_ids,
                               point_ids=point_ids, ba_state=None,
                               chunks_left=self._n_ba_chunks, event=launched_event(md))
            self._pending_map = self._pending_event = None
        else:
            self._pending_map = mapping_step(*args, n_neighbors=self.mapping_neighbors)
            self._pending_event = launched_event(md)
            self._stage = None
        self._pending_kf = kf_id
        # tracking keeps counting visible/found while the pass waits; adoption
        # re-applies those increments (they feed the found-ratio culling); the
        # snapshot stays on the session's device, where they are applied
        self._pending_counters = (t.m.mp_visible, t.m.mp_found)
        self._mapping_enqueued_frame = t.frame_id

    def _finish_stage(self, res) -> None:
        s = self._stage
        self._pending_map = mapping_finish(s["m"], s["kf"], res, s["prob"], s["cam_ids"],
                                           s["point_ids"], self.cfg)
        self._pending_event = launched_event(self.mapping_device)
        self._stage = None
        self.staged_passes += 1

    def _advance_stage(self, abort: bool = False, eager: bool = False) -> bool:
        """Launch the staged pass's next program once the current one is done
        (eager: without waiting; the stream runs them in order). abort skips
        every BA chunk not yet issued and finalizes from the best state so
        far. Returns True when the final map is in _pending_map."""
        s = self._stage
        if s is None:
            return self._pending_map is not None
        if not (abort or eager or event_done(s["event"])):
            return False
        o, t = self.cfg.optim, self.cfg.tracking
        if s["name"] == "pre":
            if abort or s["prob"] is None:
                # aborted before the BA started: no write-back
                self.ba_chunks_aborted += s["chunks_left"] + 1
                self._finish_stage(None)
                return True
            s["ba_state"] = ba_phase1(s["prob"], n_iters=o.local_ba_iters1)
            s["name"] = "ba"
            s["event"] = launched_event(self.mapping_device)
            self.ba_chunks_issued += 1
            return False
        cam_pose, points, lam, inlier = s["ba_state"]
        if not abort and s["chunks_left"] > 0:
            first = s["chunks_left"] == self._n_ba_chunks
            lam = BA_LAMBDA_INIT if first else lam   # the refinement restarts its damping
            s["ba_state"] = (*ba_phase2_chunk(s["prob"], cam_pose, points, lam, inlier,
                                              n_iters=t.ba_chunk_iters), inlier)
            s["chunks_left"] -= 1
            s["event"] = launched_event(self.mapping_device)
            self.ba_chunks_issued += 1
            return False
        # every chunk ran, or an abort: finalize the best state so far
        self.ba_chunks_aborted += s["chunks_left"] if abort else 0
        self._finish_stage(ba_finalize(s["prob"], cam_pose, points))
        return True

    def mapper_idle(self, force: bool = False, abort: bool = False) -> bool:
        """Adopt a finished mapping pass; True when no pass is in flight.
        force blocks until the pass is adopted; abort also skips every BA
        chunk not yet issued (InterruptBA for a forced keyframe insertion,
        src/Tracking.cc:1287-1303); force without abort (finish) runs the
        whole schedule."""
        chained = False
        if self._stage is not None:
            if abort:
                self._advance_stage(abort=True)
            elif force or (self.tracker.frame_id - self._mapping_enqueued_frame
                           >= self.cfg.tracking.mapping_latency_frames):
                # the latency budget is spent (or a blocking drain): issue every
                # remaining stage now, which the fused pass would have done
                while self._stage is not None:
                    self._advance_stage(eager=True)
                chained = True
            else:
                # lazily: the next stage only once its predecessor is done, so a
                # forced insertion can still abort the later chunks
                while self._stage is not None:
                    before = (self._stage["name"], self._stage["chunks_left"])
                    self._advance_stage()
                    if self._stage is not None and (self._stage["name"],
                                                    self._stage["chunks_left"]) == before:
                        break
        if self._pending_map is None:
            return self._stage is None
        busy = self.tracker.frame_id - self._mapping_enqueued_frame
        if not force and busy < self.cfg.tracking.mapping_latency_frames:
            return False
        if not (force or chained or event_done(self._pending_event)):
            return False
        # resolve the pipelined frames before the swap: a late keyframe
        # decision freezes into the map those frames were tracked on. The
        # resolution can re-enter here (the idle check of NeedNewKeyFrame),
        # adopt this pass and enqueue the next: then the token has changed
        kf_token = self._pending_kf
        self.tracker.flush_pending()
        if self._pending_kf != kf_token:
            return self._pending_map is None and self._stage is None
        t = self.tracker
        m, kf_id = self._pending_map.to(self.device), self._pending_kf
        snap_v, snap_f = self._pending_counters
        self._pending_map = self._pending_event = self._pending_counters = None
        self._pending_kf = -1
        m = m.replace(mp_visible=m.mp_visible + (t.m.mp_visible - snap_v),
                      mp_found=m.mp_found + (t.m.mp_found - snap_f))
        prev_kf_valid = t.m.kf_valid
        t.m = m
        self.mapping_passes += 1
        self._reanchor_culled_trajectory(prev_kf_valid)
        if t.ref_kf == kf_id and t.last_kf_frame == t.frame_id:
            t.last_Tcw = t.m.kf_pose[kf_id]
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(kf_id)
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
            # pipelined records in flight anchored to the slot are re-anchored
            # at resolution; earlier remaps that point at it chain on
            for k, (T_prev, r_prev) in list(t.culled_remap.items()):
                if r_prev == c:
                    t.culled_remap[k] = (T_prev @ T_cp, new_ref)
            t.culled_remap[c] = (T_cp, new_ref)
            if t.ref_kf == c and new_ref >= 0:
                t.ref_kf = new_ref

    def finish(self) -> None:
        """Resolve the pipelined frames, then adopt any waiting mapping pass
        and any global BA in flight (System::Shutdown analogue)."""
        self.tracker.flush_pending()
        self.mapper_idle(force=True)
        if self.loop_closer is not None:
            self.loop_closer.poll_global_ba(force=True)

    def compact(self) -> None:
        """Re-pack the valid keyframes and points to the front of their
        pools (slam_map/compaction.py) and remap every reference to the old
        slots. Trajectory entries whose keyframe is gone are baked to
        absolute poses (ref -1); the others are renumbered."""
        self.finish()
        t = self.tracker
        m_old = t.m
        m2, kf_map, mp_map = compact_map(m_old)
        kf_map_np = kf_map.cpu().numpy()   # the one host read
        if t.trajectory:
            T_cr = torch.stack([p for _, p, _ in t.trajectory])
            refs = np.asarray([r for _, _, r in t.trajectory])
            refs_safe = np.maximum(refs, 0)
            gone = (refs >= 0) & (kf_map_np[refs_safe] < 0)
            gone_t = torch.from_numpy(gone).to(t.device)[:, None, None]
            baked = torch.where(gone_t, T_cr @ m_old.kf_pose[torch.from_numpy(refs_safe).to(t.device)],
                                T_cr)
            new_refs = np.where((refs >= 0) & ~gone, kf_map_np[refs_safe], -1)
            t.trajectory = [(ts, baked[i], int(new_refs[i])) for i, (ts, _, _) in enumerate(t.trajectory)]
        t.m = m2
        t.n_kf_host = int(kf_map_np.max()) + 1 if (kf_map_np >= 0).any() else 0
        rk = int(kf_map_np[t.ref_kf]) if 0 <= t.ref_kf < len(kf_map_np) else -1
        t.ref_kf = rk if rk >= 0 else max(t.n_kf_host - 1, 0)
        if t.last_obs is not None:
            t.last_obs = torch.where(t.last_obs >= 0, mp_map[t.last_obs.clamp(min=0)], -1)
        t.culled_remap.clear()    # finish() resolved every record in flight
        t.bow.permute(kf_map)
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.consistency_counts.clear()
            if lc.last_loop_kf >= 0:
                lc.last_loop_kf = int(kf_map_np[lc.last_loop_kf])
            lc.loop_edges = [(int(kf_map_np[i]), int(kf_map_np[j]), S) for i, j, S in lc.loop_edges
                             if kf_map_np[i] >= 0 and kf_map_np[j] >= 0]
        self.compactions += 1

    def _pre_frame(self) -> None:
        """Adopt a finished mapping pass (never blocks), then a finished
        global BA, but only while no pass is in flight (the pass's snapshot
        predates the BA and would overwrite it); then compact the map once
        the keyframe pool is nearly full and at least 2 slots can be
        reclaimed; without reclaimable slots insertion just stays blocked
        (``_need_new_keyframe``) until culling frees some."""
        self.mapper_idle()
        if self.loop_closer is not None and self._pending_map is None and self._stage is None:
            self.loop_closer.poll_global_ba()
        t = self.tracker
        if t.n_kf_host >= t.m.max_kf - 2 and t.n_kf_host - int(t.m.kf_valid.sum()) >= 2:
            self.compact()

    def track_monocular(self, image: np.ndarray, timestamp: float) -> TrackerOutput:
        """Per-frame entry (System::TrackMonocular, src/System.cc:307-361).
        image: (H, W) grayscale, uint8 or float."""
        self._pre_frame()
        return self.tracker.process_frame(_frame(image), timestamp)

    def track_rgbd(self, image: np.ndarray, depth: np.ndarray, timestamp: float) -> TrackerOutput:
        """RGB-D entry (System::TrackRGBD, src/System.cc:260-305): image as
        in track_monocular, depth (H, W) meters (0 = no measurement)."""
        self._pre_frame()
        return self.tracker.process_frame(_frame(image), timestamp,
                                          depth=np.asarray(depth, np.float32))

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> TrackerOutput:
        """Stereo entry (System::TrackStereo, src/System.cc:215-258): a
        rectified pair; uint8 frames pass as uint8."""
        self._pre_frame()
        return self.tracker.process_frame(_frame(left), timestamp, image_right=_frame(right))

    def distributed_gba(self, mesh=None, iters: int | None = None):
        """The full-map global BA sharded over a mesh's ranks and adopted into
        the live session (the multi-device form of LoopClosing::
        RunGlobalBundleAdjustment, src/LoopClosing.cc:658-758; JAX
        tracking/system.py:544-591). Drains the pipeline first; mesh=None:
        ``make_ba_mesh`` on the session's device (a world-size-1 group when
        none is initialized). Returns the BAResult (every rank's)."""
        from ..parallel.sharded_ba import make_ba_mesh, shard_problem, solve_ba_sharded

        self.finish()
        t = self.tracker
        mesh = mesh if mesh is not None else make_ba_mesh(self.device)
        n_iters = iters if iters is not None else self.cfg.optim.global_ba_iters
        gauge = int(torch.nonzero(t.m.kf_valid)[0])
        prob, cam_ids, point_ids = extract_global_ba(t.m, t.K, t.inv_sigma2, gauge_kf=gauge,
                                                     bf=self.cfg.camera.baseline_times_fx)
        res = solve_ba_sharded(shard_problem(prob, mesh), mesh, iters1=5,
                               iters2=max(n_iters - 5, 1))
        old_ref_pose = t.m.kf_pose[t.ref_kf]
        t.m = _adopt_gba(t.m, res.cam_pose.to(self.device), cam_ids, res.points.to(self.device),
                         point_ids, t.n_kf_host)
        t.m = refresh_point_stats(t.m, t.scale_factors)
        if t.last_Tcw is not None:
            t.last_Tcw = t.last_Tcw @ se3.inv(old_ref_pose) @ t.m.kf_pose[t.ref_kf]
        t.velocity = None
        return res

    def save_map(self, path: str) -> None:
        """Checkpoint the map (after draining the mapping pipeline)."""
        checkpoint.save_map(path, self.map)

    def load_map(self, path: str) -> None:
        """Load a checkpoint onto this System's device and restore a live
        session around it (tracker.load_map): the next frame relocalizes;
        with activate_localization_mode() it only localizes."""
        self.finish()
        m, _ = checkpoint.load_map(path, self.device)
        self.tracker.load_map(m)

    def activate_localization_mode(self) -> None:
        """Tracking only, no new keyframes (System::ActivateLocalizationMode,
        src/System.cc:364)."""
        self.localization_only = True
        self.tracker.allow_keyframes = False

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False
        self.tracker.allow_keyframes = True

    def reset(self) -> None:
        """System::Reset (src/System.cc:375): a fresh map and session."""
        self._discard_pending()
        self.tracker.reset()
        self.tracker.trajectory.clear()
        self.tracker.frame_id = -1

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

    def save_trajectory_kitti(self, path: str) -> None:
        self.finish()
        _, Twc = self.tracker.trajectory_Twc()
        traj_io.save_kitti(path, Twc)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """Keyframe-only export (SaveKeyFrameTrajectoryTUM, src/System.cc:457-491)."""
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        Tcw = m.kf_pose.double().cpu().numpy()[valid]
        traj_io.save_tum(path, m.kf_timestamp.cpu().numpy()[valid], np.linalg.inv(Tcw))
