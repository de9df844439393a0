"""Command-line SLAM runner: dataset replay, trajectory export, evaluation
(port of weiner_slamit_v2_tpu/cli.py, with the same flags plus --device;
the reference's dataset-mode activity,
java/orb/slam2/android/ORBSLAMForDataSetActivity.java:120-160). Usage:

    python -m weiner_slamit_v2_torch.cli --dataset tum --root /data/fr1_xyz \\
        --sensor rgbd --out traj.txt --plot map.png --eval

    python -m weiner_slamit_v2_torch.cli --dataset synthetic --frames 60 --eval

The session runs on the card unless --device says otherwise (--device cpu).
The last line of standard output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visual SLAM runner (PyTorch/CUDA)")
    p.add_argument("--dataset", choices=["tum", "kitti", "euroc", "synthetic"],
                   default="synthetic")
    p.add_argument("--root", help="dataset root directory")
    p.add_argument("--sequence", default="00", help="KITTI sequence id")
    p.add_argument("--sensor", choices=["mono", "rgbd", "stereo"], default="mono")
    p.add_argument("--config", help="YAML config (defaults = reference values; needs pyyaml)")
    p.add_argument("--preset", help="dataset calibration preset (e.g. tum_fr1,"
                   " tum_fr2, kitti_00, euroc; default: inferred from --dataset)")
    p.add_argument("--frames", type=int, default=None, help="max frames")
    p.add_argument("--out", help="trajectory output path (TUM format)")
    p.add_argument("--out-kitti", help="trajectory output path (KITTI format)")
    p.add_argument("--plot", help="write a map plot PNG (needs matplotlib)")
    p.add_argument("--checkpoint", help="save the final map to this .npz")
    p.add_argument("--load-map", help="start from a map checkpoint (.npz)")
    p.add_argument("--localization-only", action="store_true")
    p.add_argument("--no-loop-closing", action="store_true")
    p.add_argument("--eval", action="store_true",
                   help="print ATE RMSE against ground truth if available")
    p.add_argument("--seed", type=int, default=0, help="synthetic seed")
    p.add_argument("--posenet-params", metavar="FILE.npz",
                   help="run the PoseNet person-keypoint head per frame with these params "
                        "(models/posenet.py save_params layout, either package's)")
    p.add_argument("--posenet", action="store_true",
                   help="run the PoseNet head with random weights (no params)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the session (default: the card; cpu for a CPU run)")
    return p


def load_sequence(args):
    """(Sequence, CameraConfig keyword overrides or None)."""
    from .io import datasets

    if args.dataset == "synthetic":
        import numpy as np

        K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
        return (
            datasets.make_synthetic_sequence(n_frames=args.frames or 40, h=240, w=320,
                                             seed=args.seed, motion="orbit", K=K),
            dict(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                 width=320, height=240),
        )
    if not args.root:
        raise SystemExit("--root is required for real datasets")
    if args.dataset == "tum":
        from .presets import preset

        dmf = preset(args.preset or "tum").camera.depth_map_factor
        return datasets.load_tum_rgbd(args.root, max_frames=args.frames, depth_map_factor=dmf), None
    if args.dataset == "kitti":
        # the sequence's own calib.txt wins over a range preset
        return (
            datasets.load_kitti_odometry(args.root, args.sequence, max_frames=args.frames,
                                         stereo=args.sensor == "stereo"),
            datasets.load_kitti_calib(args.root, args.sequence),
        )
    return datasets.load_euroc(args.root, max_frames=args.frames), None


def make_config(args):
    from .config import SlamConfig, load_config
    from .presets import preset

    if args.config:
        return load_config(args.config)
    if args.preset or args.dataset in ("tum", "kitti", "euroc"):
        name = args.preset or (f"kitti_{args.sequence}" if args.dataset == "kitti" else args.dataset)
        try:
            return preset(name)
        except KeyError:
            if args.preset:
                raise
            # no preset for this sequence (kitti_13..21): its calib.txt
            # supplies the camera
    return SlamConfig()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .config import CameraConfig
    from .tracking.system import System

    cfg = make_config(args)
    seq, cam_override = load_sequence(args)
    if cam_override is not None:
        cfg = cfg.replace(camera=CameraConfig(**cam_override))

    sys_ = System(cfg, device=args.device, enable_loop_closing=not args.no_loop_closing)
    if args.posenet_params:
        from .models.posenet import load_params

        sys_.tracker.enable_posenet(load_params(args.posenet_params))
    elif args.posenet:
        sys_.tracker.enable_posenet()
    if args.load_map:
        sys_.load_map(args.load_map)
    if args.localization_only:
        sys_.activate_localization_mode()

    t0 = time.time()
    n_ok = 0
    for i, f in enumerate(seq.frames):
        if args.sensor == "rgbd" and f.depth is not None:
            out = sys_.track_rgbd(f.image, f.depth, f.timestamp)
        elif args.sensor == "stereo" and f.image_right is not None:
            out = sys_.track_stereo(f.image, f.image_right, f.timestamp)
        else:
            out = sys_.track_monocular(f.image, f.timestamp)
        n_ok += out.state == "OK"
        # no per-frame map access: sys_.map drains the mapping pipeline
        print(f"[{i:5d}] {out.state:15s} inliers={out.n_inliers:4d} "
              f"kf={sys_.tracker.n_kf_host:3d}", file=sys.stderr)
    wall = time.time() - t0
    sys_.finish()

    if args.out:
        sys_.save_trajectory_tum(args.out)
    if args.out_kitti:
        sys_.save_trajectory_kitti(args.out_kitti)
    if args.checkpoint:
        sys_.save_map(args.checkpoint)
    if args.plot:
        from .viz.plotting import plot_map

        plot_map(args.plot, sys_.map)

    summary = {
        "frames": len(seq.frames),
        "tracked_ok": n_ok,
        "keyframes": sys_.n_keyframes(),
        "map_points": sys_.n_map_points(),
        "fps": round(len(seq.frames) / max(wall, 1e-9), 2),
        "device": str(sys_.device),
    }
    if args.eval and seq.gt_Twc is not None:
        from .io.evaluation import ate_rmse

        _, Twc = sys_.tracker.trajectory_Twc()
        n = min(len(Twc), len(seq.gt_Twc))
        summary["ate_rmse"] = round(
            ate_rmse(Twc[-n:], seq.gt_Twc[-n:], align_scale=args.sensor == "mono"), 5)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
