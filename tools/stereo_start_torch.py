"""Why the first frames of chip_smoke.py's stereo loop circle (phase 13) are
lost, stage by stage, on one GPU.

    python3 tools/stereo_start_torch.py [--frames 9] [--cpu] [--out FILE]

Tracks the first frames of phase 13's circle (640x480, 1024 features, bf 60)
twice: as a stereo pair (phase 13's path) and as RGB-D with the exact depth
(the plane at 2 m), which leaves the stereo matcher out. For every tracking
step it prints what the tracker's cascade saw: the motion model's matches in
its 7 px and 14 px windows, the reference-keyframe match, the count the
cascade used and whether it was the reference keyframe's, the inliers of
both pose optimizations, and whether the step had a velocity; for every
depth initialization the points made and their depth error. --cpu runs the
stereo pair on the CPU port too, to compare with the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from weiner_slamit_v2_torch.config import LoopConfig, TrackingConfig  # noqa: E402
from weiner_slamit_v2_torch.tracking import tracker as tm  # noqa: E402
from weiner_slamit_v2_torch.tracking.system import System  # noqa: E402


def step_counts(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw, ref_kf, K, sf,
                cfg, r) -> dict:
    """The cascade's counts of one track_step call (its result r)."""
    mc = cfg.matcher
    Tcw_pred = velocity @ last_Tcw if velocity is not None else last_Tcw
    n_win = [int(tm._track_last_frame(m, feats, last_obs, last_octave, last_angle, Tcw_pred, K, w, sf,
                                      cfg.orb.n_levels, mc.nn_ratio_motion, mc.th_high,
                                      mc.histo_length, None, None)[1]) for w in (7.0, 14.0)]
    _, n_ref = tm._match_reference_kf(m, feats, ref_kf, mc.nn_ratio_refkf, mc.th_low, mc.histo_length)
    s = r.scalars.tolist()
    return dict(velocity=velocity is not None, motion_7px=n_win[0], motion_14px=n_win[1],
                reference_kf=int(n_ref), used=s[tm.S_N_MATCHES], used_reference_kf=bool(s[tm.S_USED_REF]),
                inliers_1=s[tm.S_N_INL1], inliers_2=s[tm.S_N_INL2], ok_1=bool(s[tm.S_OK1]))


def run(mode: str, device: str, seq, n: int) -> list:
    L = cs.LOOP
    cfg, cam, _ = cs.bench_config(cam=dict(baseline_times_fx=cs.BF, depth_threshold=cs.DEPTH_THRESHOLD))
    cfg = cfg.replace(sensor=mode, tracking=TrackingConfig(), loop=LoopConfig())
    sys_ = System(cfg, cam, device=device)
    t = sys_.tracker
    real_step, rows = tm.track_step, []

    def step(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw, ref_kf, K, sf, inv_s2,
             cfg_, *args, **kw):
        r = real_step(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw, ref_kf, K, sf,
                      inv_s2, cfg_, *args, **kw)
        rows[-1]["step"] = step_counts(m, feats, last_obs, last_octave, last_angle, velocity, last_Tcw,
                                       ref_kf, K, sf, cfg_, r)
        return r

    tm.track_step = step
    try:
        for i in range(n):
            left = cs.uint8(seq.frames[i].image)
            rows.append(dict(frame=i))
            if mode == "stereo":
                out = sys_.track_stereo(left, cs.uint8(seq.frames[i].image_right), seq.frames[i].timestamp)
            else:
                depth = np.full(left.shape, L["depth"], np.float32)
                out = sys_.track_rgbd(left, depth, seq.frames[i].timestamp)
            rows[-1].update(state=out.state, inliers=int(out.n_inliers), resets=t.resets)
            if out.created_kf and t.n_kf_host == 1:
                m = t.m
                z_err = np.abs(m.mp_pos[m.mp_valid][:, 2].cpu().numpy() - L["depth"])
                rows[-1]["init"] = dict(points=int(m.mp_valid.sum()), z_err_median=float(np.median(z_err)),
                                        z_err_p90=float(np.percentile(z_err, 90)),
                                        over_5cm=int((z_err > 0.05).sum()))
    finally:
        tm.track_step = real_step
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--cpu", action="store_true", help="also run the CPU port")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    L = cs.LOOP
    seq = cs.loop_sequence(L["n_frames"], L["radius"], L["laps"], L["depth"], L["seed"],
                           L["start_wedge"], baseline=cs.BF / cs.WORKLOAD["f"])
    step_m = np.linalg.norm(seq.gt_Twc[1, :3, 3] - seq.gt_Twc[0, :3, 3])
    lines = [f"card: {cs.card_line()}",
             f"camera step {step_m:.5f} m a frame, {step_m * cs.WORKLOAD['f'] / L['depth']:.1f} px of image motion"]
    runs = [("stereo", "cuda"), ("rgbd", "cuda")] + ([("stereo", "cpu")] if a.cpu else [])
    for mode, device in runs:
        for row in run(mode, device, seq, a.frames):
            lines.append(f"{mode} {device} " + json.dumps(row))
    text = "\n".join(lines)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
