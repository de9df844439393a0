"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, every stage
call the window recorded (``probes.Recorder``) is run again by the plain
reference (``reference/stages.py``) and judged:

* ``frontend_diff``: entries (keypoints, undistorted keypoints, responses,
  angles, octaves, descriptors, flags) in which the program's features of a
  window frame differ from the reference's extraction of the frame the
  benchmark rendered, and, in a stereo cell, the right view's features (as
  ``match_stereo`` was handed them) from the reference's extraction of the
  rendered right image; summed over every frame of the window. Exact.
* ``stereo_match_diff`` (stereo cells): left keypoints whose stereo match
  (``match_stereo``'s depth and u_right) differs from the reference's
  (``stages.stereo_match`` on the reference's features of the rendered
  pair): kept on one side only, or kept on both with u_right half a pixel
  or more apart; summed. Exact: the images are integers, so every Hamming
  and block sum is.
* ``stereo_ur_err`` (stereo cells): the largest |u_right - the reference's|
  px over the keypoints both keep.
* ``rgbd_depth_diff`` (RGB-D cells): entries of ``depth_from_depthmap``'s
  per-keypoint depth that differ from the reference's lookup in the
  rendered depth image; summed. Exact.
* ``pose_cost_excess``: per pose LM call (tracking and relocalization), how
  much more the last round's objective reads at the program's pose than at
  the reference's optimum on the same matches; the largest over the calls.
* ``ba_inlier_diff``: per mapping pass's local BA, the share of its
  observations that the program's final state and the reference's classify
  differently (inlier or not); the largest over the passes.
* ``ba_cost_excess``: per local BA, how much more the refinement's
  objective reads at the program's cameras and points than at the
  reference's, over the points whose observations both classify alike (a
  point with an observation at the threshold is refined over other
  observations on each side); the largest over the passes.
* ``fuse_diff``: kernel B's best index / best / second distance entries that
  differ from its plain form on the fuse call's inputs; summed. Exact.
* ``pnp_deficit``: per RANSAC PnP of a relocalization, the share of the
  reference's best inlier count (the same draws, float64) that the program's
  pose falls short of; the largest over the calls.

The pose LM, the BA, the fuse and the PnP take their matches, problems and
candidate points from the program's state at the call (the reference
follows the session stage by stage); the extraction that starts every
frame, the stereo match and the depth lookup are judged against the
rendered frames alone. A number is computed and reported only where the
cell's limits name it.

With ``control`` the reference computed in bfloat16 stands in the program's
place, on the same recorded inputs.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .reference import stages

LM_BATCH = 128   # pose LM calls the reference optimizes at once


def _ba_dict(prob) -> dict:
    return {f.name: getattr(prob, f.name) for f in dataclasses.fields(prob)}


def judge(rec, tr, front: stages.FrontEnd, limits: dict, seed: int, control: bool = False,
          device=None) -> tuple[dict, set]:
    """(numbers {name: (value, limit, calls)}, frames that a number over its
    limit rejects, seconds each stage's check took). ``tr``: the rendered
    traffic (``world.Traffic``)."""
    dev = torch.device(device) if device is not None else None
    bf = torch.bfloat16
    bad: set = set()
    out, secs = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        secs[name] = round(t1 - t0, 3)
        t0 = t1

    def note(name, frame, value):
        if name in limits and value > limits[name]:
            bad.add(frame)

    def image(arr, frame, like):
        return torch.from_numpy(arr[frame]).to(dev or like.device)

    # the front end, every frame of the window, and the right view of a pair
    total = 0
    refs = {}
    for frame, feats in rec.extracts:
        img = image(tr.images, frame, feats.xy)
        refs[frame] = ref = front(img)
        got = front(img, dtype=bf) if control else feats
        d = stages.feature_diff(got, ref)
        note("frontend_diff", frame, d)
        total += d
    refs_r = {}
    for frame, args, _ in rec.stereos:
        img = image(tr.right_images, frame, args[1].xy)
        refs_r[frame] = ref = front(img, undistort=False)
        got = front(img, dtype=bf, undistort=False) if control else args[1]
        d = stages.feature_diff(got, ref)
        note("frontend_diff", frame, d)
        total += d
    lap("frontend_diff")
    out["frontend_diff"] = (total, len(rec.extracts) + len(rec.stereos))

    # the stereo match of each pair
    if "stereo_match_diff" in limits:
        total, worst = 0, 0.0
        for frame, args, (depth, ur) in rec.stereos:
            left = refs.get(frame)
            if left is None:
                left = front(image(tr.images, frame, depth))
            imgs = (image(tr.images, frame, depth).float(), image(tr.right_images, frame, depth).float())
            opts = (front.bf, front.min_z, front.scales, front.orb_cfg.n_levels)
            ref = stages.stereo_match(left, refs_r[frame], *imgs, *opts)
            if control:
                depth, ur = stages.stereo_match(left, refs_r[frame], *imgs, *opts, dtype=bf)[:2]
            d, e = stages.stereo_compare(depth, ur, ref[0], ref[1])
            note("stereo_match_diff", frame, d)
            note("stereo_ur_err", frame, e)
            total, worst = total + d, max(worst, e)
        lap("stereo_match_diff")
        out["stereo_match_diff"] = (total, len(rec.stereos))
        out["stereo_ur_err"] = (worst, len(rec.stereos))

    # the RGB-D depth lookup
    if "rgbd_depth_diff" in limits:
        total = 0
        for frame, args, got in rec.depths:
            left = refs.get(frame)
            if left is None:
                left = front(image(tr.images, frame, got))
            dmap = image(tr.depths, frame, got)
            ref = stages.depth_lookup(left, dmap)
            if control:
                got = stages.depth_lookup(left, dmap, dtype=bf)
            d = int((got.to(ref.device) != ref).sum())
            note("rgbd_depth_diff", frame, d)
            total += d
        lap("rgbd_depth_diff")
        out["rgbd_depth_diff"] = (total, len(rec.depths))

    # the pose LMs, batched by kind (with or without stereo rows)
    worst, n = 0.0, 0
    groups: dict = {}
    for frame, _, args, kw, res in rec.lms:
        key = (kw.get("ur") is not None, kw.get("n_rounds", 4), kw.get("n_iters", 10),
               float(kw.get("bf", 0.0)))
        groups.setdefault(key, []).append((frame, args, kw, res))
    for (stereo, rounds, iters, bfv), calls in groups.items():
        for i0 in range(0, len(calls), LM_BATCH):
            part = calls[i0:i0 + LM_BATCH]
            T0, X, uv, w, valid = (torch.stack([c[1][j] for c in part]) for j in range(5))
            K = part[0][1][5]
            lam = torch.tensor([c[2].get("lambda_init", 1e-3) for c in part], dtype=torch.float64)
            ur = torch.stack([c[2]["ur"] for c in part]) if stereo else None
            opts = dict(n_rounds=rounds, n_iters=iters, ur=ur, bf=bfv)
            T_ref, inl_ref = stages.pose_lm(T0, X, uv, w, valid, K, lam, **opts)
            if control:
                T_got = stages.pose_lm(T0, X, uv, w, valid, K, lam, dtype=bf, **opts)[0]
            else:
                T_got = torch.stack([c[3][0] for c in part])
            e = stages.pose_cost_excess(T_got, T_ref, inl_ref, X, uv, w, K, ur, bfv).tolist()
            for c, v in zip(part, e):
                note("pose_cost_excess", c[0], v)
            worst, n = max([worst] + e), n + len(part)
    lap("pose_cost_excess")
    out["pose_cost_excess"] = (worst, n)

    # the local BAs of the mapping passes
    es, ds = [], []
    for frame, prob, res in rec.bas:
        p = _ba_dict(prob)
        poses, pts, inl = stages.solve_ba(p)
        if control:
            got_poses, got_pts, _ = stages.solve_ba(p, dtype=bf)
            got_inl = stages.ba_final_inlier(got_poses, got_pts, p)
        else:
            got_poses, got_pts, got_inl = res.cam_pose, res.points, res.obs_inlier
        e, d = stages.ba_compare(got_poses, got_pts, got_inl, poses, pts, inl, p)
        note("ba_cost_excess", frame, e)
        note("ba_inlier_diff", frame, d)
        es.append(e)
        ds.append(d)
    lap("ba_cost_excess")
    out["ba_cost_excess"] = (max(es, default=0.0), len(es))
    out["ba_inlier_diff"] = (max(ds, default=0.0), len(ds))

    # kernel B's fuse calls
    total = 0
    for frame, args, th, res in rec.fuses:
        ref = stages.windowed_best2(args, th)
        got = stages.windowed_best2(args, th, dtype=bf) if control else res
        d = sum(int((a != b).sum()) for a, b in zip(got, ref))
        note("fuse_diff", frame, d)
        total += d
    lap("fuse_diff")
    out["fuse_diff"] = (total, len(rec.fuses))

    # the relocalization's PnP
    worst = 0.0
    for (frame, args, res), (fid, kf, n_valid) in zip(rec.pnps, rec.pnp_draw_calls):
        X, uv, has, w, K = args[:5]
        draws = stages.pnp_draws(seed, fid, kf, n_valid)
        T_ref, n_ref = stages.ransac_pnp(X, uv, has, w, K, draws)
        T_got = stages.ransac_pnp(X, uv, has, w, K, draws, dtype=bf)[0] if control else res[0]
        e = stages.pnp_deficit(T_got, n_ref, X, uv, has, w, K)
        note("pnp_deficit", frame, e)
        worst = max(worst, e)
    lap("pnp_deficit")
    out["pnp_deficit"] = (worst, len(rec.pnps))
    return {k: (v, limits[k], c) for k, (v, c) in out.items() if k in limits}, bad, secs
