"""Where the port's monocular slice spends its time on one GPU.

    python3 tools/profile_torch_slice.py [--frames 90] [--profile-from 60] [--out FILE]

Runs weiner_slamit_v2_torch's System.track_monocular on the chip_smoke.py
workload (640x480 synthetic orbit, 1024 features, mapping on) and prints:
host time per stage (extraction, tracking step, mapping pass), and a
torch.profiler table over frames [profile-from, frames): the device's busy
share of the window and the top operators by device and by host time.
--out writes the full tables to FILE.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--profile-from", type=int, default=60)
    ap.add_argument("--out", default=None, help="write the full profiler tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from weiner_slamit_v2_torch.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig
    from weiner_slamit_v2_torch.geometry.camera import Camera
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_torch.tracking import system as system_mod
    from weiner_slamit_v2_torch.tracking import tracker as tracker_mod

    H, W, f = 480, 640, 500.0
    K = np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=1024),
        camera=CameraConfig(fx=f, fy=f, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=W, height=H),
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=1, abortable_ba=False),
    )
    seq = make_synthetic_sequence(n_frames=args.frames, h=H, w=W, seed=0, motion="orbit", K=K,
                                  motion_frames=164)
    images = [np.clip(fr.image, 0, 255).astype(np.uint8) for fr in seq.frames]
    sys_ = system_mod.System(cfg, Camera.create(f, f, 320.0, 240.0, width=W, height=H),
                             device="cuda")

    stage_ms: dict[str, list[float]] = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    t = sys_.tracker
    t._extract = timed("extract", t._extract)
    tracker_mod.track_step = timed("track_step", tracker_mod.track_step)
    system_mod.mapping_step = timed("mapping_step", system_mod.mapping_step)

    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    frame_ms = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i, (img, fr) in enumerate(zip(images, seq.frames)):
        if i == args.profile_from:
            prof.start()
        t0 = time.perf_counter()
        sys_.track_monocular(img, fr.timestamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    window_s = sum(frame_ms[args.profile_from:]) / 1e3
    prof.stop()

    print(f"card: {card}")
    print(f"frames {args.frames}, states OK: {t.state}, keyframes created {t.n_kf_host}")
    print(f"frame ms (host, synchronized): median {np.median(frame_ms[5:]):.2f}, "
          f"p90 {np.percentile(frame_ms[5:], 90):.2f}")
    for name, v in stage_ms.items():
        print(f"stage {name}: n={len(v)} median {np.median(v):.2f} ms, total {sum(v):.1f} ms")
    ka = prof.key_averages()
    # one stream: device intervals do not overlap, so their sum is busy time
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type.name == "CUDA")
    print(f"profiled window: {window_s * 1e3:.1f} ms wall over {args.frames - args.profile_from} "
          f"frames; device self time {dev_us / 1e3:.1f} ms -> busy share "
          f"{dev_us / 1e6 / max(window_s, 1e-9):.3f}")
    by_dev = ka.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=25)
    print(by_dev)
    print(by_cpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(ka.table(sort_by="self_device_time_total", row_limit=200))
            fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
