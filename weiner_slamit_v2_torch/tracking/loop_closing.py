"""Loop closing: detection, Sim3, fusion, essential graph, global BA (port of
weiner_slamit_v2_tpu/tracking/loop_closing.py; the LoopClosing thread,
src/LoopClosing.cc), run after each adopted mapping pass:

1. detect (DetectLoop, LoopClosing.cc:111-245): BoW candidates outside the
   covisibility group, scored at least the group's lowest, accepted after
   ``covisibility_consistency_th`` consecutive consistent keyframes;
2. compute the Sim3 (ComputeSim3, LoopClosing.cc:247-416): BoW matching,
   RANSAC Horn Sim3, guided SearchBySim3, GN refinement (>= 20 inliers), then
   the loop region's points projected with the corrected Scw: >= 40 matches;
3. correct (CorrectLoop, LoopClosing.cc:418-598): propagate the Sim3 through
   the current covisibility group, correct its points, fuse the matched loop
   points (the loop point wins), SearchAndFuse the loop region into the group,
   optimize the essential graph, write back SE3 poses and points;
4. the global BA (RunGlobalBundleAdjustment, LoopClosing.cc:658-758): the
   full-map BA cut into chunks, issued one at a time while tracking goes on,
   superseded by a new loop or a reset, and adopted with propagation through
   the spanning tree to keyframes and points created meanwhile.

Host decisions (the gates, the consistency groups, the essential graph's
edge list) read the device as the JAX package does; everything else stays
on the device. The RANSAC draws come through the ``sim3_draws(kf_id,
n_valid)`` hook.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend import matcher
from ..geometry import se3, sim3
from ..ops import hamming
from ..optim import sim3_solver
from ..optim.ba_extract import extract_global_ba
from ..optim.local_ba import ba_finalize, ba_phase1, ba_phase2_chunk
from ..optim.pose_graph import correct_map_after_pose_graph, optimize_pose_graph
from ..slam_map import types as mt
from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.point_stats import predict_octave, refresh_point_stats
from ..slam_map.types import SlamMap
from ..util import event_done, launched_event, put, put_last, topk
from .local_mapping import _fuse_points_into_kf


class LoopCloser:
    def __init__(self, cfg: SlamConfig, tracker):
        self.cfg = cfg
        self.tracker = tracker
        # last_loop_kf, consistency_counts and loop_edges survive a reset and
        # load_map, as in the JAX package (ROADMAP C records it as a fault of
        # both packages)
        self.last_loop_kf = -1_000
        self.consistency_counts: dict[int, int] = {}
        self.n_loops_closed = 0
        self.gba_chunks_issued = 0
        self.run_global_ba = True
        # stereo / RGB-D maps are metric: every Sim3 keeps scale 1
        # (bFixScale, src/LoopClosing.cc:73)
        self.fix_scale = cfg.sensor != "monocular"
        self._pending_gba: Optional[dict] = None
        # (i, j, S_ji) of every closed loop, for later essential graphs
        # (KeyFrame::mspLoopEdges)
        self.loop_edges: list[tuple[int, int, torch.Tensor]] = []
        # RANSAC draws: (kf_id, n_valid) -> (N_ITERS, 3)
        self.sim3_draws = self._default_sim3_draws

    def _default_sim3_draws(self, kf_id: int, n_valid: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.cfg.seed + 97 * kf_id)
        return sim3_solver.draw_samples(n_valid, g, self.tracker.device)

    # -- the concurrent global BA ------------------------------------------------
    def _enqueue_global_ba(self, gauge_kf: int) -> None:
        """The full-map BA: the robust phase now, the refinement chunks from
        poll_global_ba, one per poll once the previous one is done (mbStopGBA
        stops issuing them, src/LoopClosing.cc:429-442, 658-688)."""
        t, cfg = self.tracker, self.cfg
        prob, cam_ids, point_ids = extract_global_ba(t.m, t.K, t.inv_sigma2, gauge_kf=gauge_kf,
                                                     bf=cfg.camera.baseline_times_fx)
        per = max(cfg.tracking.ba_chunk_iters, 1)
        n_refine = max(cfg.optim.global_ba_iters - 5, 0)
        state = ba_phase1(prob, n_iters=5)
        self.gba_chunks_issued += 1
        self._pending_gba = dict(res=None, prob=prob, state=state, event=launched_event(t.device),
                                 chunks_left=-(-n_refine // per) if n_refine else 0,
                                 cam_ids=cam_ids, point_ids=point_ids, n_kf_snap=t.n_kf_host)

    def discard_pending_gba(self) -> None:
        """Supersede the running global BA: no further chunk is issued."""
        self._pending_gba = None

    def _advance_gba(self, g: dict, eager: bool = False) -> bool:
        """Issue the next chunk, or finalize, once the previous launch is done
        (eager: without waiting). True once the result exists. The chunks
        carry the damping on from ba_phase1, as in the JAX package (the local
        mapping pass restarts its refinement at BA_LAMBDA_INIT)."""
        if g["res"] is not None:
            return True
        if not (eager or event_done(g["event"])):
            return False
        cam_pose, points, lam, inlier = g["state"]
        if g["chunks_left"] > 0:
            g["state"] = (*ba_phase2_chunk(g["prob"], cam_pose, points, lam, inlier,
                                           n_iters=self.cfg.tracking.ba_chunk_iters), inlier)
            g["chunks_left"] -= 1
            g["event"] = launched_event(self.tracker.device)
            self.gba_chunks_issued += 1
            return False
        g["res"] = ba_finalize(g["prob"], cam_pose, points)
        g["event"] = launched_event(self.tracker.device)
        return True

    def poll_global_ba(self, force: bool = False) -> bool:
        """Advance the global BA; adopt it once done (force: issue everything
        and adopt now). True if one was adopted. A reset since the enqueue
        leaves nothing to adopt."""
        g = self._pending_gba
        if g is None:
            return False
        if force:
            while not self._advance_gba(g, eager=True):
                pass
        else:
            progressed = True
            while progressed and g["res"] is None:
                left = g["chunks_left"]
                done = self._advance_gba(g)
                progressed = done or g["chunks_left"] != left
            if g["res"] is None or not event_done(g["event"]):
                return False
        self._pending_gba = None
        t = self.tracker
        if t.n_kf_host < g["n_kf_snap"] or t.n_kf_host == 0:
            return False
        t.flush_pending()
        old_ref_pose = t.m.kf_pose[t.ref_kf]
        t.m = _adopt_gba(t.m, g["res"].cam_pose, g["cam_ids"], g["res"].points, g["point_ids"],
                         g["n_kf_snap"])
        t.m = refresh_point_stats(t.m, t.scale_factors)
        # the tracking chain moves with its reference keyframe's correction
        if t.last_Tcw is not None:
            t.last_Tcw = t.last_Tcw @ se3.inv(old_ref_pose) @ t.m.kf_pose[t.ref_kf]
        t.velocity = None
        return True

    # -- per keyframe --------------------------------------------------------------
    def on_keyframe(self, kf_id: int) -> bool:
        """Run detection and closing for a keyframe; True if a loop closed."""
        t = self.tracker
        if not t.bow.ready or kf_id < self.last_loop_kf + self.cfg.loop.min_kfs_between_loops:
            return False
        cand = self._detect(kf_id)
        if cand is None:
            return False
        ok = self._close(kf_id, cand)
        if ok:
            self.last_loop_kf = kf_id
            self.n_loops_closed += 1
            self.consistency_counts.clear()
        return ok

    def _detect(self, kf_id: int) -> Optional[int]:
        """BoW loop candidates with covisibility-consistency accumulation."""
        cfg, t = self.cfg, self.tracker
        m = t.m
        W = covisibility_matrix(m)
        Wnp = W.cpu().numpy()
        covis_group = set(np.nonzero(Wnp[kf_id] > 0)[0].tolist()) | {kf_id}

        # the lowest score among the covisible neighbors (LoopClosing.cc:137-153)
        v = t.bow.row_query(kf_id)
        neigh = [k for k in covis_group if k != kf_id]
        min_score = float(t.bow.score_rows(neigh, v).min()) if neigh else 0.0

        exclude = np.zeros(m.max_kf, bool)
        exclude[list(covis_group)] = True
        # recent keyframes (LoopClosing.cc:124) and culled ones (their BoW
        # rows stay; the validity mask is KeyFrameDatabase::erase)
        exclude |= np.arange(m.max_kf) > kf_id - cfg.loop.min_kfs_between_loops
        exclude |= ~m.kf_valid.cpu().numpy()
        _, keep = t.bow.candidates(v, torch.from_numpy(exclude).to(m.device), W.float(), min_score)
        cands = np.nonzero(keep.cpu().numpy())[0]
        if len(cands) == 0:
            self.consistency_counts.clear()
            return None

        # a candidate's group must have been a candidate group of the previous
        # keyframe too (LoopClosing.cc:170-243)
        new_counts: dict[int, int] = {}
        chosen = None
        for c in cands:
            group = set(np.nonzero(Wnp[c] > 0)[0].tolist()) | {int(c)}
            cnt = max((self.consistency_counts.get(g, 0) for g in group), default=0) + 1
            for g in group:
                new_counts[g] = max(new_counts.get(g, 0), cnt)
            if cnt >= cfg.loop.covisibility_consistency_th:
                chosen = int(c)
        self.consistency_counts = new_counts
        return chosen

    def _close(self, kf_id: int, cand: int) -> bool:
        """ComputeSim3 (LoopClosing.cc:247-416), then CorrectLoop."""
        cfg, t = self.cfg, self.tracker
        m = t.m
        n_levels = cfg.orb.n_levels

        # 1. BoW-style matching of the two keyframes' map points
        has1 = (m.kf_obs[kf_id] >= 0) & m.kf_feat_valid[kf_id]
        has2 = (m.kf_obs[cand] >= 0) & m.kf_feat_valid[cand]
        idx, _ = matcher.match_by_descriptor(
            m.kf_desc[kf_id], m.kf_desc[cand], has1, has2, max_dist=cfg.matcher.th_low,
            nn_ratio=cfg.matcher.nn_ratio_bow, angle1=m.kf_angle[kf_id], angle2=m.kf_angle[cand])
        if int((idx >= 0).sum()) < cfg.loop.min_bow_matches:
            return False

        # 2. RANSAC Horn Sim3 over 3-point sets
        pairs = _matched_pairs(m, kf_id, cand, idx, t.inv_sigma2, n_levels)
        draws = self.sim3_draws(kf_id, max(int(pairs[2].sum()), 1))
        S12, _, n_inl = sim3_solver.ransac_sim3(*pairs, t.K, draws, fix_scale=self.fix_scale)
        if int(n_inl) < cfg.loop.min_sim3_inliers:
            return False

        # 3. guided SearchBySim3 widening (LoopClosing.cc:333-343)
        idx2 = search_by_sim3(m, kf_id, cand, S12, 7.5, t.K, t.scale_factors, t.bounds)
        idx = torch.where(idx >= 0, idx, idx2)

        # 4. GN refinement (OptimizeSim3, >= 20 inliers)
        pairs = _matched_pairs(m, kf_id, cand, idx, t.inv_sigma2, n_levels)
        S12, _, n_inl = sim3_solver.refine_sim3(S12, *pairs, t.K, chi2_th=cfg.loop.sim3_chi2,
                                                fix_scale=self.fix_scale)
        if int(n_inl) < cfg.loop.min_sim3_inliers:
            return False

        # 5. the total-match gate (LoopClosing.cc:352-401): the loop region's
        # points (the candidate and its covisible keyframes) projected with
        # the corrected Scw
        W = covisibility_matrix(m)
        loop_group = (W[cand] > 0) | (torch.arange(m.max_kf, device=m.device) == cand)
        loop_mask = _points_of_group(m, loop_group)
        S_cw = S12 @ sim3.from_se3(m.kf_pose[cand])
        matched_loop = _project_loop_points(m, kf_id, S_cw, loop_mask, 10.0, t.K,
                                            t.scale_factors, t.bounds)
        if int((matched_loop >= 0).sum()) < cfg.loop.min_total_matches:
            return False
        self._correct(kf_id, cand, S12, S_cw, loop_mask, matched_loop)
        return True

    def _correct(self, kf_id, cand, S12, S_cw, loop_mask, matched_loop) -> None:
        """CorrectLoop (LoopClosing.cc:418-598)."""
        cfg, t = self.cfg, self.tracker
        m = t.m
        K_ = m.max_kf
        dev = m.device

        W = covisibility_matrix(m)
        group = (W[kf_id] > 0) | (torch.arange(K_, device=dev) == kf_id)
        m, S_old, S_corr = _propagate_and_fuse(m, kf_id, S_cw, group, matched_loop)
        # SearchAndFuse over the corrected group (LoopClosing.cc:600-626)
        m = _search_and_fuse(m, group, loop_mask, t.K, t.scale_factors, t.sigma2, cfg)
        t.m = m

        # the essential graph: spanning tree, strong covisibility, past loops
        # (Optimizer.cc:826-922); the edge list is built on the host
        Wnp = covisibility_matrix(m).cpu().numpy()
        kf_valid_np = m.kf_valid.cpu().numpy()
        parent_np = m.kf_parent.cpu().numpy()
        edges_i, edges_j = [], []
        for k in np.nonzero(kf_valid_np)[0].tolist():
            p = int(parent_np[k])
            if p >= 0 and kf_valid_np[p]:
                edges_i.append(k)
                edges_j.append(p)
        for i, j in np.argwhere(np.triu(Wnp, 1) >= cfg.loop.essential_min_covis_weight):
            edges_i.append(int(i))
            edges_j.append(int(j))
        past = [(i, j, S) for (i, j, S) in self.loop_edges if kf_valid_np[i] and kf_valid_np[j]]
        E_base = len(edges_i)
        edge_i = torch.tensor(edges_i + [i for i, _, _ in past] + [cand], dtype=torch.int32,
                              device=dev)
        edge_j = torch.tensor(edges_j + [j for _, j, _ in past] + [kf_id], dtype=torch.int32,
                              device=dev)
        # measurements from the poses before the correction (NonCorrectedSim3);
        # loop edges carry their computed Sim3
        edge_S = torch.cat([_relative_sim3(S_old, edge_i[:E_base], edge_j[:E_base])]
                           + [S[None] for _, _, S in past] + [S12[None]])
        edge_valid = torch.ones(edge_i.shape[0], dtype=torch.bool, device=dev)
        fixed = torch.arange(K_, device=dev) == cand          # Optimizer.cc:840
        S_opt = optimize_pose_graph(S_corr, m.kf_valid, fixed, edge_i, edge_j, edge_S, edge_valid,
                                    n_iters=cfg.optim.essential_graph_iters,
                                    lambda_init=cfg.optim.essential_lambda_init,
                                    fix_scale=self.fix_scale)

        # SE3 poses and corrected points
        T_new = se3.orthonormalize(sim3.to_se3(S_opt))
        mp_pos = correct_map_after_pose_graph(m.mp_pos, m.mp_valid, m.mp_first_kf, S_corr, S_opt)
        t.m = m.replace(kf_pose=torch.where(m.kf_valid[:, None, None], T_new, m.kf_pose),
                        mp_pos=mp_pos)
        self.loop_edges.append((cand, kf_id, S12))
        # tracking continues from the corrected current keyframe
        t.last_Tcw = t.m.kf_pose[kf_id]
        t.velocity = None

        if self.run_global_ba:
            # a global BA still running from an earlier loop is superseded
            self.discard_pending_gba()
            self._enqueue_global_ba(gauge_kf=cand)


# -- the stages ----------------------------------------------------------------------

def _adopt_gba(m: SlamMap, ba_pose, cam_ids, ba_pts, point_ids, n_kf_snap: int) -> SlamMap:
    """A finished global BA written into the current map (src/LoopClosing.cc:
    689-748): its keyframes take their poses; keyframes allocated after the
    snapshot follow their spanning-tree parent, T_child_new = T_child_old
    T_parent_old^-1 T_parent_new (parents have smaller slot ids, so one pass
    in slot order settles chains; only slots >= n_kf_snap can chain, and the
    parents and validity are read once); its points take their positions,
    the others move with their first observer's correction."""
    old_pose = m.kf_pose
    kf_pose = put(old_pose, torch.where(cam_ids >= 0, cam_ids, m.max_kf), ba_pose)
    parent = m.kf_parent.cpu().numpy()
    valid = m.kf_valid.cpu().numpy()
    for k in range(int(n_kf_snap), m.max_kf):
        p = int(parent[k])
        if p >= 0 and valid[k]:
            kf_pose[k] = old_pose[k] @ se3.inv(old_pose[p]) @ kf_pose[p]

    pt_w = torch.where(point_ids >= 0, point_ids, m.max_mp)
    in_ba = put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device), pt_w, True)
    mp_pos = put(m.mp_pos, pt_w, ba_pts)
    ref = torch.where(m.mp_obs_kf[:, 0] >= 0, m.mp_obs_kf[:, 0], m.mp_first_kf.clamp(min=0))
    ref = ref.clamp(0, m.max_kf - 1).long()
    corr = se3.inv(kf_pose) @ old_pose
    Xc = se3.apply(corr[ref], m.mp_pos)
    need = m.mp_valid & ~in_ba
    return m.replace(kf_pose=kf_pose, mp_pos=torch.where(need[:, None], Xc, mp_pos))


def _matched_pairs(m: SlamMap, kf_id: int, cand: int, idx, inv_sigma2, n_levels: int):
    """The inputs of ransac_sim3 / refine_sim3 for matches idx (feature of
    kf_id -> feature of cand): (X1, X2, valid, uv1, uv2, inv_sigma2_1,
    inv_sigma2_2), points in each keyframe's camera frame."""
    ok = idx >= 0
    i2 = idx.clamp(min=0).long()
    mp1 = m.kf_obs[kf_id].clamp(min=0).long()
    mp2 = m.kf_obs[cand][i2].clamp(min=0).long()
    X1 = se3.apply(m.kf_pose[kf_id], m.mp_pos[mp1])
    X2 = se3.apply(m.kf_pose[cand], m.mp_pos[mp2])
    s2_1 = inv_sigma2[m.kf_octave[kf_id].clamp(0, n_levels - 1).long()]
    s2_2 = inv_sigma2[m.kf_octave[cand][i2].clamp(0, n_levels - 1).long()]
    valid = ok & (m.kf_obs[kf_id] >= 0) & m.mp_valid[mp1] & m.mp_valid[mp2]
    return X1, X2, valid, m.kf_xy[kf_id], m.kf_xy[cand][i2], s2_1, s2_2


def _project_gate(m: SlamMap, pid, S_dw, K, scale_factors, bounds):
    """Points ``pid`` through a Sim3 world->camera: (u, v, predicted
    octave, in frustum and scale band)."""
    L = scale_factors.shape[0]
    Pc = sim3.apply(S_dw, m.mp_pos[pid])
    z = Pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    dist3 = torch.linalg.norm(Pc, dim=1)
    ok = ((z > 0) & (dist3 >= 0.8 * m.mp_min_dist[pid]) & (dist3 <= 1.2 * m.mp_max_dist[pid])
          & (u >= bounds[0]) & (u < bounds[1]) & (v >= bounds[2]) & (v < bounds[3]))
    pred = predict_octave(dist3, m.mp_max_dist[pid], scale_factors[1], L)
    return u, v, pred, ok


def _window_pairs(m: SlamMap, kf: int, u, v, win, oct_lo, oct_hi):
    xy = m.kf_xy[kf]
    octf = m.kf_octave[kf]
    return (((xy[None, :, 0] - u[:, None]).abs() < win[:, None])
            & ((xy[None, :, 1] - v[:, None]).abs() < win[:, None])
            & (octf[None, :] >= oct_lo[:, None]) & (octf[None, :] <= oct_hi[:, None]))


def search_by_sim3(m: SlamMap, kf1: int, kf2: int, S12, th: float, K, scale_factors, bounds):
    """ORBmatcher::SearchBySim3 (src/ORBmatcher.cc:1106-1328): each keyframe's
    points projected into the other through the Sim3, mutual agreements
    kept. Returns (N,) feature of kf1 -> feature of kf2, or -1."""
    L = scale_factors.shape[0]

    def direction(src, dst, S_dc):
        """Per feature of src: the best feature of dst for its point."""
        obs = m.kf_obs[src]
        mp = obs.clamp(min=0).long()
        has = (obs >= 0) & m.kf_feat_valid[src] & m.mp_valid[mp]
        u, v, pred, okp = _project_gate(m, mp, S_dc @ sim3.from_se3(m.kf_pose[src]), K,
                                        scale_factors, bounds)
        okp = okp & has
        win = th * scale_factors[pred.clamp(0, L - 1)]
        pair = _window_pairs(m, dst, u, v, win, pred - 1, pred)
        dist = hamming.masked_distance_matrix(m.mp_desc[mp], m.kf_desc[dst], okp,
                                              m.kf_feat_valid[dst], pair)
        fidx, best, _ = hamming.best_and_second(dist)
        return torch.where(okp & (best <= matcher.TH_HIGH), fidx, -1)

    # S12 maps camera 2 to camera 1: kf2's points go into kf1 through S12,
    # kf1's into kf2 through S21
    fwd = direction(kf2, kf1, S12)           # kf2 feature r2 -> kf1 feature
    bwd = direction(kf1, kf2, sim3.inv(S12))  # kf1 feature -> kf2 feature
    n = m.n_feat
    # several kf2 rows can claim one kf1 feature (no column-unique step):
    # the largest row wins, the JAX package's last write
    agree = put(torch.full((n,), -1, dtype=torch.int32, device=m.device),
                torch.where(fwd >= 0, fwd, n), torch.arange(n, dtype=torch.int32, device=m.device),
                "max")
    mutual = (agree >= 0) & (bwd == agree) & (bwd >= 0)
    return torch.where(mutual, agree, -1)


def _points_of_group(m: SlamMap, group_mask) -> torch.Tensor:
    """(M,) mask of the valid points any keyframe of the group observes."""
    flat = torch.where((group_mask & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    return put(torch.zeros(m.max_mp, dtype=torch.bool, device=m.device),
               torch.where(flat >= 0, flat, m.max_mp), True) & m.mp_valid


def _project_loop_points(m: SlamMap, kf: int, S_cw, loop_mask, th: float, K, scale_factors,
                         bounds) -> torch.Tensor:
    """SearchByProjection with a Sim3 world->camera (ORBmatcher.cc:294-407):
    loop-region points against the keyframe's features. Returns (N,) loop
    point per feature or -1; a feature whose point is already a loop point
    keeps it."""
    L = scale_factors.shape[0]
    vals, pid = topk(torch.where(loop_mask, m.mp_n_obs, -1), min(4096, m.max_mp))
    pid = pid.clamp(min=0)
    u, v, pred, okp = _project_gate(m, pid, S_cw, K, scale_factors, bounds)
    okp = okp & (vals >= 0)
    win = th * scale_factors[pred.clamp(0, L - 1)]
    pair = _window_pairs(m, kf, u, v, win, pred - 1, pred + 1)
    dist = hamming.masked_distance_matrix(m.mp_desc[pid], m.kf_desc[kf], okp,
                                          m.kf_feat_valid[kf], pair)
    fidx, best, _ = hamming.best_and_second(dist)
    ok = okp & (best <= matcher.TH_LOW)
    ok = ok & matcher.column_unique_best(fidx, best, ok, m.n_feat)
    out = put(torch.full((m.n_feat,), -1, dtype=torch.int32, device=m.device),
              torch.where(ok, fidx.clamp(min=0), m.n_feat), torch.where(ok, pid, -1))
    cur = m.kf_obs[kf]
    already = (cur >= 0) & loop_mask[cur.clamp(min=0)]
    return torch.where(already, cur, out)


def _relative_sim3(S_poses, edge_i, edge_j) -> torch.Tensor:
    """S_ji = S_j S_i^-1 per edge."""
    return sim3.compose(S_poses[edge_j.long()], sim3.inv(S_poses[edge_i.long()]))


def _propagate_and_fuse(m: SlamMap, kf: int, S_cw, group_mask, matched_loop):
    """CorrectLoop's propagation, point correction and loop-point
    replacement (LoopClosing.cc:456-556). Returns (map, S_old (K,4,4)
    before the correction, S_corr after)."""
    K_ = m.max_kf
    dev = m.device
    S_old = sim3.from_se3(m.kf_pose)
    S_prop = sim3.compose(sim3.from_se3(m.kf_pose @ se3.inv(m.kf_pose[kf])), S_cw)
    grp = group_mask & m.kf_valid
    S_corr = torch.where(grp[:, None, None], S_prop, S_old)

    # points seen by the group move with their first group observer:
    # X' = S_corr^-1 S_old X (LoopClosing.cc:480-505)
    obs_kf = m.mp_obs_kf
    obs_in_grp = (obs_kf >= 0) & grp[obs_kf.clamp(min=0).long()]
    first = torch.where(obs_in_grp, obs_kf, K_).amin(1)
    has_ref = (first < K_) & m.mp_valid
    corr = sim3.inv(S_corr) @ S_old
    Xc = sim3.apply(corr[first.clamp(0, K_ - 1).long()], m.mp_pos)
    mp_pos = torch.where(has_ref[:, None], Xc, m.mp_pos)
    kf_pose = torch.where(grp[:, None, None], se3.orthonormalize(sim3.to_se3(S_corr)), m.kf_pose)
    m = m.replace(mp_pos=mp_pos, kf_pose=kf_pose)

    # loop fusion: the keyframe's matched points are replaced by the loop
    # points (the loop point wins, LoopClosing.cc:540-556)
    n = m.n_feat
    p, q = matched_loop, m.kf_obs[kf]
    okm = (p >= 0) & m.mp_valid[p.clamp(min=0).long()]
    add = okm & (q < 0)
    kf_obs = m.kf_obs.clone()
    kf_obs[kf] = put(q, torch.where(add, torch.arange(n, device=dev), n), torch.where(add, p, -1))
    merge = okm & (q >= 0) & (q != p) & m.mp_valid[q.clamp(min=0).long()]
    Mx = m.max_mp
    loser, winner = q.clamp(min=0), p.clamp(min=0)
    # a point seen at two features loses twice: the later feature's winner
    # takes its slot, as in the JAX package
    r = put_last(torch.arange(Mx, dtype=torch.int32, device=dev), torch.where(merge, loser, Mx),
                 torch.where(merge, winner, -1))
    r = r[r.long()]
    kf_obs = torch.where(kf_obs >= 0, r[kf_obs.clamp(min=0).long()], kf_obs)
    lw = torch.where(merge, winner, Mx)
    lo = loser.long()
    m = m.replace(
        kf_obs=kf_obs,
        mp_valid=put(m.mp_valid, torch.where(merge, loser, Mx), False),
        mp_found=put(m.mp_found, lw, torch.where(merge, m.mp_found[lo], 0), "add"),
        mp_visible=put(m.mp_visible, lw, torch.where(merge, m.mp_visible[lo], 0), "add"),
    )
    return mt.rebuild_observation_lists(m), S_old, S_corr


def _search_and_fuse(m: SlamMap, group_mask, loop_mask, K, scale_factors, sigma2, cfg: SlamConfig,
                     max_targets: int = 24) -> SlamMap:
    """LoopClosing::SearchAndFuse (LoopClosing.cc:600-626): the loop points
    projected into the corrected group's keyframes, most recent first (at
    most max_targets), window 4, the loop point winning every merge."""
    inv_s2 = 1.0 / sigma2
    sel = torch.where(group_mask & m.kf_valid, m.kf_frame_id + 1, -1)
    vals, targets = topk(sel, min(max_targets, m.max_kf))
    for k, ok in zip(targets.tolist(), (vals > 0).tolist()):
        if ok:
            m = _fuse_points_into_kf(m, loop_mask & m.mp_valid, k, K, scale_factors, inv_s2, cfg,
                                     max_points=cfg.capacity.local_ba_points, window_mult=4.0,
                                     prefer_src=True)
    return mt.rebuild_observation_lists(m)
