"""Which host synchronizations the port's tracking makes, on one GPU.

    python3 tools/sync_audit_torch.py [--frames 80] [--out FILE]

Runs System.track_monocular over chip_smoke.py's bench workload (640x480
synthetic orbit, 1024 features, mapping on, mapping_latency_frames=8) twice:
with frames_per_sync=4 (bench.py's configuration: pipeline_warmup_kfs 8) and
with frames_per_sync=1. Every synchronizing call torch makes
(``torch.cuda.set_sync_debug_mode("warn")``: one warning per call) is
recorded with the port's part of the Python stack that made it, in one of
two scopes: inside a batch launch (``Tracker._launch_batch``, which should
make none) or elsewhere in a frame. Prints the call sites by count and the
calls per frame of each run; --out writes every call site.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(fps: int, n_frames: int, images, seq, cfg, cam, sites, per_frame):
    from weiner_slamit_v2_torch.tracking.system import System
    from weiner_slamit_v2_torch.tracking.tracker import Tracker

    cfg = cfg.replace(tracking=cfg.tracking.__class__(mapping_latency_frames=8, frames_per_sync=fps))
    sys_ = System(cfg, cam)
    scope = ["frame"]
    real_launch = Tracker._launch_batch
    n_batches = [0]

    def launch(self, recs):
        scope[0] = "batch"
        try:
            return real_launch(self, recs)
        finally:
            scope[0] = "frame"
            n_batches[0] += 1

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1] if "weiner_slamit_v2_torch" in f.filename]
        key = tuple(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}" for f in stack[-4:])
        sites[(fps, scope[0], key)] += 1
        count[0] += 1

    count = [0]
    Tracker._launch_batch = launch
    try:
        with warnings.catch_warnings():     # restores showwarning and the filters
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            for i in range(n_frames):
                before = count[0]
                sys_.track_monocular(images[i], seq.frames[i].timestamp)
                per_frame.append((fps, i, count[0] - before))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        Tracker._launch_batch = real_launch
    sys_.finish()
    return sys_, n_batches[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--out", default=None, help="write every call site's stack here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess

    import chip_smoke
    from weiner_slamit_v2_torch.ops import cuda_build

    cuda_build.build(cuda_build.sources())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cfg, cam, seq, images = chip_smoke.workload(args.frames)
    sites, per_frame = collections.Counter(), []
    lines = [f"card: {card}"]
    for fps in (4, 1):
        sys_, n_batches = run(fps, args.frames, images, seq, cfg, cam, sites, per_frame)
        counts = [c for f, i, c in per_frame if f == fps and i >= args.frames // 2]
        batch_calls = sum(n for (f, sc, _), n in sites.items() if f == fps and sc == "batch")
        lines.append(f"frames_per_sync={fps}: {n_batches} batches launched, {batch_calls} synchronizing "
                     f"calls inside them; per frame over frames {args.frames // 2}-{args.frames - 1}: "
                     f"median {np.median(counts)}, mean {np.mean(counts):.2f}, max {max(counts)}; "
                     f"keyframes {sys_.tracker.n_kf_host}, state {sys_.tracker.state}")
    lines.append("call sites (frames_per_sync, scope, count, innermost port frames):")
    for (fps, sc, key), n in sites.most_common():
        lines.append(f"  fps={fps} {sc:5s} {n:6d}  {' <- '.join(reversed(key))}")
    print("\n".join(lines[:60]))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
