"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit code):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from weiner_slamit_v2_torch/csrc with nvcc (one
     process per source, all at once), with csrc/v1 beside them: the first,
     per-level designs, loaded here only, and timed beside the current ones;
  3. kernel A (FAST + NMS over all pyramid levels in one launch) against its
     plain version on a 640x480 frame's 8 levels and on odd level sets:
     bit-exact; device times per frame of the kernel, the v1 design and the
     plain version;
  4. kernel B (gated windowed Hamming best/second) against its plain version
     on random inputs at the fuse shape and on the adversarial cases of
     ops/kernel_cases.py: exact; device times at the random shapes;
  5. the monocular slice: System.track_monocular (System on the card by
     default) over 120 synthetic 640x480 frames, 1024 features, local
     mapping on; asserts initialization, OK tracking from then on, keyframe
     and mapping-pass counts, the kernels' launch counts on that run (kernel
     A once per frame), and the scale-aligned ATE. One kernel-B call of the
     fuse is recorded;
  6. kernel B at the recorded fuse inputs: exact; device times of the
     kernel, the v1 design and the plain version, and the inputs' sparsity:
     rows with valid1, columns per row's window, columns the binned kernel
     visits;
  7. occlusion and relocalization: the same workload with the default
     TrackingConfig (abortable_ba=True: the staged mapping pass) over 200
     frames, frames 150-155 a constant 128 image (a covered lens). Asserts
     the vocabulary trained at 4 keyframes and retrained at 16, LOST on
     frame 150 with no reset, OK again by frame 165 and to the end, every
     staged pass's BA stages issued or aborted once each, kernel A once per
     frame and kernel B at least once per pass, and the ATE over the OK
     frames; prints the relocalization (frame, candidates, inliers) and the
     times of the training, retraining and relocalization frames;
  8. early loss, with the default TrackingConfig: 60 frames, the two frames
     after initialization blank, while the map holds <= 5 keyframes. Asserts
     one reset (a fresh map and BoW index), reinitialization and OK to the
     end;
  9. RGB-D (the JAX campaign's config-3 proxy): System.track_rgbd over 150
     frames of the occluding multi-plane world with photometric noise and
     exact depth maps (sensor "rgbd", bf 60, depth threshold 40). Asserts OK
     from frame 0 (depth initialization) to the end, more than one keyframe,
     metric ATE, kernel A once per frame and B once per mapping pass; then
     save_map, a fresh System on the card load_map's it (arrays equal to the
     file's) and, in localization mode, relocalizes on one of frames 0-7;
 10. stereo (the config-4 proxy without loop closing): System.track_stereo
     over 150 frames of a loop in the same world, baseline 0.12 m (bf 60),
     uint8 pairs. Asserts OK to the end, >= 2 keyframes, > 100 points,
     metric ATE, kernel A twice per frame, B once per pass; on the first
     frame >= 80 stereo matches with a median depth error < 0.15 m against
     the rendered depth; prints match_stereo's device time there;
 11. compaction: the phase-5 workload over 200 frames with a 12-keyframe
     pool (local BA window 6): asserts at least one compaction (System.
     compact called by the per-frame trigger), > 80 % of frames OK, finite
     poses and the scale-aligned ATE; prints the compact() times;
 12. monocular loop closure (System(..., enable_loop_closing=True), the
     default TrackingConfig, LoopConfig and capacities): a circle flown a
     little over once over a plane whose start is textured apart, with the
     keyframes and points of the start moved by the gauge drift of
     tests/test_loop.py at half a lap. Every keyframe runs the detection;
     what it proposes is what closes. Asserts a loop closed, the
     scale-aligned ATE of the frames tracked before the first closure lower
     after finish() than just before it, kernel A once per frame and B once per mapping pass, finite
     orthonormal keyframe poses, and every adopted global BA issued in
     1 + ceil(15 / 5) chunks; prints each closure's stage times, the essential
     graph's device time, and the global BA's time and peak memory;
 13. stereo with loop closing on (the JAX campaign's config-4 proxy): phase
     10's sequence and config; asserts phase 10's end-to-end checks and that
     every Sim3 of every closure keeps scale 1; prints the closures.
 14. distributed global BA: phase 12's map after its finish() (256 keyframe
     and 16,384 point slots), every non-gauge keyframe's translation and
     every point moved by seeded N(0, 0.01), then System.distributed_gba
     (iters=20) over a world-size-1 NCCL group on a file store (which
     checks the wiring and measures no scaling). Asserts 41 all_reduce
     calls, a lower scale-aligned ATE of phase 12's OK frames, the adopted
     result's poses within 1e-3 and points within 1e-2 of solve_ba(5, 15) on
     the problem that call solved, two solve_ba runs equal, finite
     orthonormal keyframe poses; prints the call's time and peak memory;
 15. PoseNet: the first 60 frames of phase 5's run with
     tracker.enable_posenet(). Asserts
     last_person finite (17, 2) / (17,) / (17,) on the card with scores in
     [0, 1] on every frame, phase 5's OK and ATE bounds, one frame's
     heatmaps on the card within 1e-5 of the same module on the CPU (argmax
     cells equal wherever the top-two margin exceeds it), kernel A once per
     frame and B once per pass; prints ms/frame beside phase 5's and the
     head's device time;
 16. data-parallel extraction: 8 bench-orbit frames at 640x480 through
     batched_extract and sharded_extract (world size 1): bit-equal to
     per-frame extraction, kernel A once per frame;
 17. mapping on another device: System(device="cuda", mapping_device="cpu")
     at 320x240 with 512 features over 40 frames. Asserts OK after
     initialization, adopted passes and the adopted map on the card;
 18. the CLI on the card: ``python -m weiner_slamit_v2_torch.cli --dataset
     synthetic --frames 40 --eval --posenet`` with --out and --checkpoint in
     a subprocess: exit 0, both files written, its JSON line with
     tracked_ok > 20 and an ate_rmse.
The kernel launch counts of phases 5, 7-17 are each read from zero. With
phase numbers as arguments (``python3 chip_smoke.py 9 10``) only those of
phases 7-18 run, after phases 1-6 (phase 14 brings phase 12 with it).
Prints one line per kernel (v1 time, time, plain time, bound, share), a JSON
line of kernel results (launches: summed over the phases that ran in this
process), the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

N_FRAMES = 120
ATE_BOUND_M = 0.06
# the bench.py workload (bench.py:50-80): 640x480 synthetic orbit, seed 0,
# the 164-frame pace, fx = fy = 500, 1024 features, mapping latency 8 frames
WORKLOAD = dict(H=480, W=640, f=500.0, n_features=1024, seed=0, motion_frames=164)
RELOC = dict(n_frames=200, blank=range(150, 156), ok_by=165)   # phase 7
RESET_FRAMES = 60                                             # phase 8
POSENET_FRAMES = 60       # phase 15: the first half of phase 5's run, to save time
# phases 9-11: the JAX campaign's config 3 and 4 proxies
# (tools/run_baseline.py:237-309) at the bench geometry, and a small pool
DEPTH_FRAMES = 150
BF = 60.0                     # baseline 0.12 m x fx 500
DEPTH_THRESHOLD = 40.0
RGBD_SEQ = dict(seed=6, motion="orbit", world="multi", photometric_noise=2.0, with_depth=True)
STEREO_SEQ = dict(seed=7, motion="loop", world="multi", photometric_noise=2.0, with_depth=True,
                  stereo_baseline=BF / 500.0)
COMPACT = dict(n_frames=200, max_keyframes=12, local_ba_window=6)
# phase 12: a loop of radius 2.4 m (the out-and-back amplitude of
# tests/test_loop.py widened to this footprint) flown 1.21 times in 176 frames
# (~26 px per frame, the out-and-back's fastest), its start (the wedge from
# start_wedge[0] to start_wedge[1] rad of the circle) textured apart; at half
# a lap (frame 72) the keyframes of the first 24 frames and their points take
# the test's gauge drift; the ATE before the first closure is read after
# frame 80
LOOP = dict(n_frames=176, radius=2.4, laps=1.21, depth=2.0, seed=31, apex=72, drift_frames=24,
            eval_from=80, start_wedge=(-0.35, 1.1))
# NVIDIA H100 SXM peaks (data sheet, 700 W): HBM bytes/s, float32 operations/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# kernel A per pixel in its design: 2 x 57 arc min/max, 2 subtractions, the
# polarity max, the threshold, 8 NMS compares and the select
FAST_OPS_PER_PX = 127
# kernel B: gate operations per (valid row, valid column) pair, and the
# XOR/popcount/add work of a pair that passes every gate
GATE_OPS_PER_PAIR = 8
DIST_OPS_PER_PAIR = 24
# kernel B's bytes: a usable row (valid1, a window > 0, a finite prediction)
# reads its descriptor, flag, xy, window and octave range and writes 3 ints;
# a row with valid1 but no usable window reads its flag, xy and window; a row
# without valid1 only its flag. A valid column is read whole, any other only
# for its flag
ROW_BYTES = 32 + 1 + 8 + 4 + 4 + 4 + 12
ROW_UNUSABLE_BYTES = 1 + 8 + 4 + 12
ROW_INVALID_BYTES = 1 + 12
COL_BYTES, COL_INVALID_BYTES = 32 + 1 + 8 + 4 + 4, 1
# C entry points of the first designs (csrc/v1/), in their C signatures' order
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
V1_SIGNATURES = {
    "fast_score_nms_v1_launch": [_P, _P, _I, _I, _P],   # (img, out, H, W, stream)
    # (d1, v1, pxy, win, lo, hi, d2, v2, xy2, oct2, w2, th, best_idx, best_dist,
    #  second_dist, B, N1, N2, stream)
    "windowed_best2_v1_launch": [_P] * 11 + [_F] + [_P] * 3 + [_I] * 3 + [_P],
}
_v1 = None
# phase 5's frame times (phase 15 prints its own beside them) and phase 12's
# session and sequence (phase 14 runs the distributed BA on its map)
SLICE_MS: dict = {}
LOOP_RUN: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A phase's check: raises (the run exits non-zero), also under -O."""
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 100, loops: int = 5) -> float:
    """Device time of one fn() in ms: the median over ``loops`` windows of one
    CUDA event pair around ``reps`` calls, divided by ``reps``.

    The reps calls are captured once into a CUDA graph and the window replays
    it, so the host's enqueue cost (ctypes, argument checks, torch.empty),
    which can exceed a small kernel's run time, is not in the window. The
    inputs stay warm in L2 between calls, as on the main path, where the
    pyramid and the fuse's gathers have just written them: no flush."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(loops):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    torch.cuda.synchronize()
    return float(np.median(times))


def eager_ms(fn, reps: int = 100, loops: int = 5) -> float:
    """The same window with the reps calls issued from Python: includes the
    host's enqueue time wherever it exceeds the device's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(loops):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- the first designs (csrc/v1), called directly for timing -----------------

def fast_v1(levels):
    from weiner_slamit_v2_torch.ops import cuda_build

    outs, stream = [], torch.cuda.current_stream().cuda_stream
    for img in levels:
        out = torch.empty_like(img)
        cuda_build.check(_v1.fast_score_nms_v1_launch(img.data_ptr(), out.data_ptr(),
                                                      img.shape[0], img.shape[1], stream), "v1 A")
        outs.append(out)
    return outs


def best2_v1(*args):
    from weiner_slamit_v2_torch.ops import cuda_build

    (d1, d2, v1, v2, pxy, xy2, win, lo, hi, o2, w2), th = args[:11], args[11]
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    outs = [torch.empty((B, N1), dtype=torch.int32, device=d1.device) for _ in range(3)]
    ptrs = [t.data_ptr() for t in (d1, v1, pxy, win, lo, hi, d2, v2, xy2, o2, w2)]
    cuda_build.check(_v1.windowed_best2_v1_launch(
        *ptrs, float(th), *(o.data_ptr() for o in outs), B, N1, N2,
        torch.cuda.current_stream().cuda_stream), "v1 B")
    return tuple(outs)


# --- phases --------------------------------------------------------------------

def phase_kernel_a(frame: np.ndarray, dev) -> dict:
    from weiner_slamit_v2_torch.ops import kernel_cases, pyramid
    from weiner_slamit_v2_torch.ops.fast_kernel import (fast_score_nms_levels,
                                                        fast_score_nms_levels_plain)

    levels = [l.contiguous() for l in
              pyramid.build_pyramid(torch.from_numpy(frame).to(dev).float(), 8, 1.2)]
    sets = {"640x480 pyramid": levels, **kernel_cases.fast_level_sets(dev)}
    err = None
    for name, lv in sets.items():
        outs, refs, olds = fast_score_nms_levels(lv), fast_score_nms_levels_plain(lv), fast_v1(lv)
        torch.cuda.synchronize()
        for i, (o, r, v) in enumerate(zip(outs, refs, olds)):
            check(torch.equal(o, r), f"kernel A != plain on {name} level {i} "
                  f"{tuple(lv[i].shape)}: {int((o != r).sum())} pixels differ")
            check(torch.equal(v, r), f"v1 kernel A != plain on {name} level {i}")
        if err is None:   # the 640x480 pyramid's
            err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
        log(f"kernel A {name} {[tuple(l.shape) for l in lv]}: equal, "
            f"corners={[int((o > 0).sum()) for o in outs]}")
    px = sum(l.numel() for l in levels)
    k_ms = device_ms(lambda: fast_score_nms_levels(levels))
    v1_ms = device_ms(lambda: fast_v1(levels))
    p_ms = device_ms(lambda: fast_score_nms_levels_plain(levels), reps=100, loops=3)
    k_eager = eager_ms(lambda: fast_score_nms_levels(levels))
    v1_eager = eager_ms(lambda: fast_v1(levels))
    b_ms, b_by = bound(8.0 * px, FAST_OPS_PER_PX * px)
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.add_(1.0))
    log(f"launch floor: a one-element torch kernel, timed the same way: {floor_ms:.5f} ms")
    log(f"kernel A per frame ({px} px in 8 levels), device time: v1 {v1_ms:.5f} ms, "
        f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms; with host enqueue (eager loop): "
        f"v1 {v1_eager:.5f} ms, kernel {k_eager:.5f} ms")
    return dict(name="fast_score_nms", route="cuda",
                source="weiner_slamit_v2_torch/csrc/fast_score_nms.cu",
                replaces="weiner_slamit_v2_tpu/ops/fast_pallas.py:123",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, v1_ms=v1_ms)


def check_b(args, th, label: str) -> tuple:
    """Kernel B's and v1's outputs against the plain version's, exact; returns
    the kernel's outputs and their largest absolute difference from plain."""
    from weiner_slamit_v2_torch.ops.match_kernel import windowed_best2, windowed_best2_plain

    out, ref, old = windowed_best2(*args, th), windowed_best2_plain(*args, th), best2_v1(*args, th)
    torch.cuda.synchronize()
    for name, a, b, v in zip(("best_idx", "best_dist", "second_dist"), out, ref, old):
        check(torch.equal(a, b), f"kernel B {name} != plain on {label}: "
              f"{int((a != b).sum())} entries differ")
        check(torch.equal(v, b), f"v1 kernel B {name} != plain on {label}")
    return out, max(float((a - b).abs().max()) for a, b in zip(out, ref))


def phase_kernel_b(dev) -> None:
    from weiner_slamit_v2_torch.ops import kernel_cases
    from weiner_slamit_v2_torch.ops.match_kernel import windowed_best2, windowed_best2_plain

    for (B, N1, N2, th) in [(20, 1024, 1024, 5.991), (3, 1000, 777, 0.0)]:
        args = kernel_cases.random_matcher_args(B, N1, N2, seed=B + N2, device=dev)
        out, _ = check_b(args, th, f"random {(B, N1, N2)}")
        k_ms = device_ms(lambda: windowed_best2(*args, th))
        v1_ms = device_ms(lambda: best2_v1(*args, th))
        p_ms = device_ms(lambda: windowed_best2_plain(*args, th), reps=20, loops=3)
        log(f"kernel B random {(B, N1, N2)} chi2_th={th} windows 3-60 px: equal, rows with a "
            f"candidate={int((out[1] < 10_000).sum())}; device time: v1 {v1_ms:.5f} ms, "
            f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms")
    cases = kernel_cases.matcher_cases(dev)
    for name, args, th in cases:
        check_b(args, th, name)
    log(f"kernel B adversarial set: {len(cases)} cases equal ({', '.join(n for n, _, _ in cases)})")


def gate_mask(args, th):
    """(B, N1, N2) bool: the pairs that pass every gate (the plain rule)."""
    _, _, v1, v2, pxy, xy2, win, lo, hi, o2, w2 = args
    du = xy2[:, None, :, 0] - pxy[:, :, None, 0]
    dv = xy2[:, None, :, 1] - pxy[:, :, None, 1]
    ok = (du.abs() < win[..., None]) & (dv.abs() < win[..., None])
    ok &= (o2[:, None, :] >= lo[..., None]) & (o2[:, None, :] <= hi[..., None])
    ok &= v1[..., None] & v2[:, None, :]
    if th > 0:
        ok &= (du * du + dv * dv) * w2[:, None, :] <= th
    return ok


def visited_columns(args) -> tuple[int, int]:
    """(columns scanned, rows that scan) of the binned kernel B, replicated in
    float32 torch: the grid, the cell map, the dense switch. The kernel rounds
    the box edges outward where this rounds to nearest, so a column on a cell
    edge may count one cell off."""
    _, _, v1, v2, pxy, xy2, win = args[:7]
    total = rows = 0
    for b in range(v1.shape[0]):
        xy = xy2[b][v2[b] & torch.isfinite(xy2[b]).all(1)]
        rv = v1[b] & (win[b] > 0) & torch.isfinite(pxy[b]).all(1)
        rows += int(rv.sum())
        nb = xy.shape[0]
        if nb == 0 or not bool(rv.any()):
            continue
        g = max(1, min(32, int(math.sqrt(nb))))
        lo, hi = xy.min(0).values, xy.max(0).values
        scale = g / (hi - lo)
        scale = torch.where((hi > lo) & torch.isfinite(scale), scale, 0.0)

        def cell(v, axis):
            t = torch.floor((v - lo[axis]) * scale[axis])
            return torch.nan_to_num(t, nan=0.0).clamp(0, g - 1).long()

        counts = torch.zeros((g + 1, g + 1), dtype=torch.int64, device=xy.device)
        counts.index_put_((cell(xy[:, 1], 1) + 1, cell(xy[:, 0], 0) + 1),
                          torch.ones(nb, dtype=torch.int64, device=xy.device), accumulate=True)
        P = counts.cumsum(0).cumsum(1)
        p, w = pxy[b][rv], win[b][rv]
        x0, x1 = cell(p[:, 0] - w, 0), cell(p[:, 0] + w, 0)
        y0, y1 = cell(p[:, 1] - w, 1), cell(p[:, 1] + w, 1)
        box = P[y1 + 1, x1 + 1] - P[y0, x1 + 1] - P[y1 + 1, x0] + P[y0, x0]
        dense = 2 * (x1 - x0 + 1) * (y1 - y0 + 1) > g * g
        total += int(torch.where(dense, nb, box).sum())
    return total, rows


def phase_kernel_b_fuse(captured, dev) -> dict:
    from weiner_slamit_v2_torch.ops.match_kernel import windowed_best2, windowed_best2_plain

    args, th = list(captured[:11]), captured[11]
    B, N1, N2 = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    _, err = check_b(args, th, f"the recorded fuse call {(B, N1, N2)}")
    k_ms = device_ms(lambda: windowed_best2(*args, th))
    v1_ms = device_ms(lambda: best2_v1(*args, th))
    p_ms = device_ms(lambda: windowed_best2_plain(*args, th), reps=20, loops=3)
    v1r, v2c = args[2], args[3]
    n_rows = int(v1r.sum())
    valid_pairs = int((v1r.sum(1) * v2c.sum(1)).sum())
    passing = int(gate_mask(args, th).sum())
    _, _, _, _, pxy, xy2, win = args[:7]
    in_box = ((xy2[:, None, :, 0] - pxy[:, :, None, 0]).abs() < win[..., None]) & \
             ((xy2[:, None, :, 1] - pxy[:, :, None, 1]).abs() < win[..., None]) & v2c[:, None, :]
    n_box = int((in_box & v1r[..., None]).sum())
    n_visit, n_scan = visited_columns(args)

    # the bound at this call's data: bytes by ROW_*/COL_* above; operations:
    # the gates on the columns in each valid row's window, and the distance
    # on the pairs that pass every gate
    usable = v1r & (win > 0) & torch.isfinite(pxy).all(-1)
    n_cols = int(v2c.sum())
    n_bytes = (int(usable.sum()) * ROW_BYTES + (n_rows - int(usable.sum())) * ROW_UNUSABLE_BYTES
               + (B * N1 - n_rows) * ROW_INVALID_BYTES
               + n_cols * COL_BYTES + (B * N2 - n_cols) * COL_INVALID_BYTES)
    b_ms, b_by = bound(n_bytes, GATE_OPS_PER_PAIR * n_box + DIST_OPS_PER_PAIR * passing)
    log(f"kernel B at the recorded fuse inputs: shape {(B, N1, N2)}, chi2_th={th}, "
        f"windows {float(win[v1r].min()) if n_rows else 0:.3f}-"
        f"{float(win[v1r].max()) if n_rows else 0:.3f} px; rows with valid1 {n_rows} of {B * N1} "
        f"({n_rows / (B * N1):.4f}); valid (row, column) pairs {valid_pairs}; columns in a "
        f"valid row's window {n_box / max(n_rows, 1):.3f} per row; columns the binned kernel "
        f"visits {n_visit / max(n_scan, 1):.3f} per scanning row ({n_scan} rows); pairs passing "
        f"every gate {passing}; bytes the call needs {n_bytes}; device time: v1 {v1_ms:.5f} ms, "
        f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms")
    return dict(name="windowed_best2", route="cuda",
                source="weiner_slamit_v2_torch/csrc/windowed_best2.cu",
                replaces="weiner_slamit_v2_tpu/ops/match_pallas.py:157",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, v1_ms=v1_ms)


def uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_config(cam: dict | None = None, **tracking):
    """(config, camera, K) of the bench geometry with frames_per_sync=1, the
    given TrackingConfig fields and CameraConfig fields ``cam``."""
    from weiner_slamit_v2_torch.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig
    from weiner_slamit_v2_torch.geometry.camera import Camera

    w = WORKLOAD
    H, W, f = w["H"], w["W"], w["f"]
    cx, cy = W / 2, H / 2
    cfg = SlamConfig(
        orb=OrbConfig(n_features=w["n_features"]),
        camera=CameraConfig(fx=f, fy=f, cx=cx, cy=cy, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=W, height=H, **(cam or {})),
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=1, **tracking),
    )
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    return cfg, Camera.create(f, f, cx, cy, width=W, height=H), K


def workload(n_frames: int, cam: dict | None = None, seq: dict | None = None, **tracking):
    """(config, camera, sequence, uint8 frames) of the bench workload
    (bench_config) over make_synthetic_sequence arguments ``seq`` (default:
    the bench orbit)."""
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence

    w = WORKLOAD
    cfg, camera, K = bench_config(cam, **tracking)
    seq = make_synthetic_sequence(n_frames=n_frames, h=w["H"], w=w["W"], K=K,
                                  motion_frames=w["motion_frames"],
                                  **(seq or dict(seed=w["seed"], motion="orbit")))
    images = [uint8(fr.image) for fr in seq.frames]
    return cfg, camera, seq, images


def reset_launches() -> None:
    from weiner_slamit_v2_torch.ops import fast_kernel, match_kernel

    fast_kernel.launches = 0
    match_kernel.launches = 0


def read_launches() -> dict:
    from weiner_slamit_v2_torch.ops import fast_kernel, match_kernel

    return {"fast_score_nms": fast_kernel.launches, "windowed_best2": match_kernel.launches}


def ok_frames_ate(sys_, states, gt, first: int = 0) -> float:
    """Scale-aligned ATE over the OK frames from frame ``first`` on; the
    trajectory's entry j is frame init + j (every frame after the first
    initialization logs one entry)."""
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse

    _, Twc = sys_.tracker.trajectory_Twc()
    init = states.index("OK")
    sel = [j for j in range(len(Twc)) if init + j >= first and states[init + j] == "OK"]
    check(np.isfinite(Twc).all() and len(sel) > 10, f"trajectory {Twc.shape}, {len(sel)} OK frames")
    return ate_rmse(Twc[sel], gt[init:][sel])


def drive(sys_, images, seq, blank=(), on_frame=None, feed=None):
    """Feed the frames (``blank`` ones replaced by a constant 128 image),
    synchronizing the card after each; returns (states, ms per frame).
    feed(i, image): the entry point (default track_monocular)."""
    feed = feed or (lambda i, img: sys_.track_monocular(img, seq.frames[i].timestamp))
    states, frame_ms = [], []
    for i, img in enumerate(images):
        if i in blank:
            img = np.full_like(img, 128)
        t0 = time.perf_counter()
        out = feed(i, img)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(out.state)
        if on_frame is not None:
            on_frame(i, out)
    sys_.finish()
    torch.cuda.synchronize()
    return states, frame_ms


def phase_slice(dev, card: str):
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse
    from weiner_slamit_v2_torch.tracking import local_mapping
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(N_FRAMES, abortable_ba=False)
    sys_ = System(cfg, cam)   # the card by default
    check(sys_.device.type == dev.type and sys_.tracker.m.kf_pose.is_cuda, str(sys_.device))

    # record the fuse's kernel-B call with the most targets (the latest on a tie)
    real_best2, captured = local_mapping.windowed_best2, []

    def recorder(*args):
        out = real_best2(*args)
        if not captured or args[0].shape[0] >= captured[0].shape[0]:
            captured[:] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return out

    local_mapping.windowed_best2 = recorder
    reset_launches()
    try:
        states, frame_ms = drive(sys_, images, seq)
    finally:
        local_mapping.windowed_best2 = real_best2
    launches = read_launches()

    init = next((i for i, s in enumerate(states) if s == "OK"), None)
    check(init is not None, f"never initialized: {states}")
    n_created = sys_.tracker.n_kf_host
    n_kf = sys_.n_keyframes()
    n_pass = sys_.mapping_passes
    ts, Twc = sys_.tracker.trajectory_Twc()
    ate = ate_rmse(Twc, seq.gt_Twc[-len(Twc):])
    steady = frame_ms[init + 1:]
    log(f"slice: init at frame {init}, states after init: "
        f"{sum(s == 'OK' for s in states[init:])} OK of {N_FRAMES - init}, keyframes created="
        f"{n_created} (valid after culling {n_kf}), map points={sys_.n_map_points()}, "
        f"adopted mapping passes={n_pass}, ATE={ate:.5f} m, launches={launches}")
    log(f"slice: median {np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} "
        f"ms/frame, max {max(steady):.3f} ms (host clock, synchronized per frame) on {card}")
    SLICE_MS.update(median=float(np.median(steady)), p90=float(np.percentile(steady, 90)))
    check(all(s == "OK" for s in states[init:]), f"lost after init: {states}")
    check(n_created >= 8, f"only {n_created} keyframes created")
    check(n_pass >= 4, f"only {n_pass} adopted mapping passes")
    check(launches["fast_score_nms"] == N_FRAMES, str(launches))   # one launch per frame
    check(launches["windowed_best2"] >= n_pass, str((launches, n_pass)))
    check(np.isfinite(Twc).all() and Twc.shape == (N_FRAMES - init, 4, 4), str(Twc.shape))
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    check(bool(captured), "the fuse never called kernel B")
    return launches, captured


def phase_reloc(dev, card: str) -> dict:
    """Phase 7: the default (staged) pipeline through a covered lens."""
    from weiner_slamit_v2_torch.optim import pnp
    from weiner_slamit_v2_torch.tracking import tracker as tracker_mod
    from weiner_slamit_v2_torch.tracking.system import System

    n, blank, ok_by = RELOC["n_frames"], RELOC["blank"], RELOC["ok_by"]
    cfg, cam, seq, images = workload(n)
    check(cfg.tracking.abortable_ba and cfg.tracking.ba_chunk_iters == 5, str(cfg.tracking))
    sys_ = System(cfg, cam, device=dev)
    t = sys_.tracker
    relocs, kf_frames = [], []
    # synchronized host times of the vocabulary (re)trainings and of each
    # relocalization attempt, inside their frames' times, and of the parts of
    # each attempt: candidate search, PnP, pose LMs, projection-retry matching
    calls = {"vocabulary": [], "relocalize": [], "reloc_parts": []}
    parts = []    # the attempt in progress: [dict of part -> ms]

    def timed(fn, record):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def part(name, fn):
        """fn timed as a part of a relocalization attempt; untimed elsewhere
        (the pose LM also runs twice in every tracked frame)."""
        def add(ms):
            parts[-1][name] = round(parts[-1].get(name, 0.0) + ms, 3)

        timed_fn = timed(fn, add)
        return lambda *args, **kwargs: timed_fn(*args, **kwargs) if parts else fn(*args, **kwargs)

    def relocalize(*args):
        parts.append({})
        try:
            return timed(reloc, lambda ms: calls["relocalize"].append(round(ms, 3)))(*args)
        finally:
            calls["reloc_parts"].append(parts.pop())

    for name in ("maybe_train", "retrain"):
        setattr(t.bow, name, timed(getattr(t.bow, name),
                                   lambda ms: calls["vocabulary"].append(round(ms, 3))))
    reloc = t._relocalize
    t._relocalize = relocalize
    t._reloc_candidates = part("candidates", t._reloc_candidates)
    patched = [(pnp, "ransac_pnp", "pnp"), (tracker_mod, "_pose_opt_on_obs", "pose_lm"),
               (tracker_mod, "_reloc_widen", "retry_match")]
    originals = [getattr(mod, attr) for mod, attr, _ in patched]
    for mod, attr, name in patched:
        setattr(mod, attr, part(name, getattr(mod, attr)))

    def on_frame(i, out):
        if out.state == "OK" and i > 0 and t.last_reloc_frame == i:
            relocs.append(dict(t.last_reloc_attempt))
        if out.created_kf:
            kf_frames.append(i)

    reset_launches()
    try:
        states, frame_ms = drive(sys_, images, seq, blank, on_frame)
    finally:
        for (mod, attr, _), fn in zip(patched, originals):
            setattr(mod, attr, fn)
    launches = read_launches()

    first = blank[0]
    back = next((i for i in range(first, n) if states[i] == "OK"), None)
    stages = 1 + sys_._n_ba_chunks
    trainings = t.vocab_trainings
    ate = ok_frames_ate(sys_, states, seq.gt_Twc)
    init = states.index("OK")
    steady = [ms for i, ms in enumerate(frame_ms) if i > init]
    kf_ms = [frame_ms[i] for i in kf_frames if i > init]
    other_ms = [ms for i, ms in enumerate(frame_ms) if i > init and i not in kf_frames
                and i not in blank and i != back]
    log(f"reloc: init at frame {init}, vocabulary (keyframes, frame) {trainings}, LOST frames "
        f"{[i for i, s in enumerate(states) if s == 'LOST']}, OK again at frame {back}, "
        f"relocalizations {relocs}, keyframes created {t.n_kf_host} (valid {sys_.n_keyframes()}), "
        f"resets {t.resets}, staged passes {sys_.staged_passes} (adopted {sys_.mapping_passes}), "
        f"BA stages issued {sys_.ba_chunks_issued} aborted {sys_.ba_chunks_aborted}, "
        f"ATE over OK frames {ate:.5f} m, launches {launches}")
    log(f"reloc: median {np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} "
        f"ms/frame, max {max(steady):.3f} ms; vocabulary frames "
        f"{[(k, f, round(frame_ms[f], 3)) for k, f in trainings]} (keyframes, frame, ms); "
        f"blank (LOST) frames ms {[round(frame_ms[i], 3) for i in blank]}; relocalization "
        f"frame ms {round(frame_ms[back], 3) if back is not None else None}; median of the "
        f"{len(kf_ms)} keyframe frames {np.median(kf_ms):.3f} ms, of the {len(other_ms)} other "
        f"OK frames {np.median(other_ms):.3f} ms; inside them: vocabulary (re)training ms "
        f"{calls['vocabulary']}, relocalization calls ms {calls['relocalize']}, their parts "
        f"ms {calls['reloc_parts']} (host clock, synchronized per frame) on {card}")
    check([k for k, _ in trainings[:2]] == [4, 16] and trainings[1][1] < first,
          f"vocabulary trainings {trainings}: want 4 and 16 keyframes before frame {first}")
    check(states[first] == "LOST" and t.resets == 0, f"frame {first}: {states[first]}, resets {t.resets}")
    check(back is not None and back <= ok_by and relocs and relocs[0]["frame"] == back,
          f"OK again at frame {back} (want <= {ok_by}), relocalizations {relocs}")
    check(all(s == "OK" for s in states[back:]), f"lost after relocalization: {states[back:]}")
    check(all(s == "OK" for s in states[init:first]), f"lost before the blank frames: {states}")
    check(sys_.ba_chunks_issued > 0 and sys_._stage is None
          and sys_.ba_chunks_issued + sys_.ba_chunks_aborted == stages * sys_.staged_passes,
          f"BA stages {sys_.ba_chunks_issued} + {sys_.ba_chunks_aborted} != {stages} x "
          f"{sys_.staged_passes} passes")
    check(launches["fast_score_nms"] == n, str(launches))
    check(launches["windowed_best2"] >= sys_.staged_passes >= sys_.mapping_passes > 0, str(launches))
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    return launches


def phase_reset(dev) -> dict:
    """Phase 8: a loss within the first 5 keyframes resets the session; the
    TrackingConfig is the default one, as a user constructs it."""
    from weiner_slamit_v2_torch.config import TrackingConfig
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(RESET_FRAMES)
    cfg = cfg.replace(tracking=TrackingConfig())
    sys_ = System(cfg, cam, device=dev)
    t = sys_.tracker
    blank, at_loss = [], {}

    def on_frame(i, out):
        if out.state == "OK" and not blank:
            blank.extend((i + 1, i + 2))          # the two frames after initialization
        if out.state == "LOST" and not at_loss:
            at_loss.update(frame=i, n_kf=t.n_kf_host, bow_ready=t.bow.ready, resets=t.resets,
                           n_kf_valid=int(t.m.kf_valid.sum()))

    reset_launches()
    states, _ = drive(sys_, images, seq, blank, on_frame)
    launches = read_launches()
    reinit = next((i for i in range(blank[-1] + 1, len(states)) if states[i] == "OK"), None)
    ate = ok_frames_ate(sys_, states, seq.gt_Twc, reinit) if reinit is not None else float("nan")
    log(f"reset: blank frames {blank}, at the loss {at_loss}, resets {t.resets}, reinitialized at "
        f"frame {reinit}, keyframes since {t.n_kf_host}, ATE over the new session's OK frames "
        f"{ate:.5f} m, launches {launches}")
    check(at_loss.get("frame") == blank[0] and at_loss["resets"] == 1 and at_loss["n_kf"] == 0
          and at_loss["n_kf_valid"] == 0 and not at_loss["bow_ready"], f"at the loss: {at_loss}")
    check(t.resets == 1, f"{t.resets} resets")
    check(reinit is not None and all(s == "OK" for s in states[reinit:]),
          f"no reinitialization to the end: {states}")
    check(launches["fast_score_nms"] == RESET_FRAMES and launches["windowed_best2"] >= 1,
          str(launches))
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    return launches


def depth_asserts(label: str, sys_, states, frame_ms, launches, seq, per_frame: int, card: str):
    """The checks shared by the RGB-D and stereo runs; returns the metric ATE."""
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse

    n = len(states)
    _, Twc = sys_.tracker.trajectory_Twc()
    check(np.isfinite(Twc).all() and Twc.shape == (n, 4, 4), f"{label} trajectory {Twc.shape}")
    ate = ate_rmse(Twc, seq.gt_Twc, align_scale=False)
    steady = frame_ms[1:]
    log(f"{label}: states {sum(s == 'OK' for s in states)} OK of {n}, keyframes created "
        f"{sys_.tracker.n_kf_host} (valid {sys_.n_keyframes()}), map points {sys_.n_map_points()}, "
        f"staged passes {sys_.staged_passes} (adopted {sys_.mapping_passes}), BA stages issued "
        f"{sys_.ba_chunks_issued} aborted {sys_.ba_chunks_aborted}, metric ATE {ate:.5f} m, "
        f"launches {launches}")
    log(f"{label}: median {np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} "
        f"ms/frame, max {max(steady):.3f} ms, first frame {frame_ms[0]:.3f} ms (host clock, "
        f"synchronized per frame) on {card}")
    check(all(s == "OK" for s in states), f"{label}: not OK from frame 0 to the end: {states}")
    check(sys_.n_keyframes() >= 2 and sys_.n_map_points() > 100,
          f"{label}: {sys_.n_keyframes()} keyframes, {sys_.n_map_points()} points")
    check(launches["fast_score_nms"] == per_frame * n, f"{label}: {launches}, want A {per_frame} x {n}")
    check(launches["windowed_best2"] >= sys_.staged_passes >= sys_.mapping_passes > 0,
          f"{label}: {launches}, passes {sys_.staged_passes}")
    check(ate < ATE_BOUND_M, f"{label}: metric ATE {ate} m >= {ATE_BOUND_M} m")
    return ate


def phase_rgbd(dev, card: str) -> dict:
    """Phase 9: RGB-D, then the map through a checkpoint into a fresh
    localization-only session."""
    import tempfile

    from weiner_slamit_v2_torch.slam_map.convert import map_to_numpy
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(DEPTH_FRAMES, cam=dict(baseline_times_fx=BF,
                                     depth_threshold=DEPTH_THRESHOLD), seq=RGBD_SEQ)
    cfg = cfg.replace(sensor="rgbd")
    sys_ = System(cfg, cam)
    feed = lambda i, img: sys_.track_rgbd(img, seq.frames[i].depth, seq.frames[i].timestamp)  # noqa: E731
    first = []

    def on_frame(i, out):
        if i == 0:
            first.append(out.created_kf)

    reset_launches()
    states, frame_ms = drive(sys_, images, seq, feed=feed, on_frame=on_frame)
    launches = read_launches()
    check(first == [True], f"rgbd: frame 0 made no keyframe: {first}")
    depth_asserts("rgbd", sys_, states, frame_ms, launches, seq, 1, card)

    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/map.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_.save_map(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        s2 = System(cfg, cam)    # the card by default
        t0 = time.perf_counter()
        s2.load_map(path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        with np.load(path) as z:
            got = map_to_numpy(s2.tracker.m)
            diff = [k for k in z.files if not np.array_equal(z[k], got[k])]
            size = sum(z[k].nbytes for k in z.files)
        check(not diff and s2.tracker.m.kf_pose.is_cuda, f"loaded map differs in {diff}")
        check(s2.tracker.state == "LOST" and s2.tracker.n_kf_host == sys_.tracker.n_kf_host,
              f"after load_map: {s2.tracker.state}, {s2.tracker.n_kf_host} keyframes")
        s2.activate_localization_mode()
        reloc = None
        for i in range(8):
            out = s2.track_rgbd(images[i], seq.frames[i].depth, 100.0 + i / 30.0)
            if out.state == "OK":
                reloc = (i, out.n_inliers)
                break
    log(f"rgbd checkpoint: save_map {save_ms:.3f} ms, load_map {load_ms:.3f} ms ({size} bytes of "
        f"arrays; the loaded arrays equal the file's), relocalized (frame, inliers) {reloc}, "
        f"last attempt {s2.tracker.last_reloc_attempt} on {card}")
    check(reloc is not None, "no relocalization against the loaded map in frames 0-7")
    check(s2.tracker.n_kf_host == sys_.tracker.n_kf_host, "localization mode added a keyframe")
    return launches


def phase_stereo(dev, card: str) -> dict:
    """Phase 10: stereo; the matcher's accuracy and device time on frame 0."""
    from weiner_slamit_v2_torch.ops.stereo import match_stereo
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(DEPTH_FRAMES, cam=dict(baseline_times_fx=BF,
                                     depth_threshold=DEPTH_THRESHOLD), seq=STEREO_SEQ)
    cfg = cfg.replace(sensor="stereo")
    rights = [uint8(fr.image_right) for fr in seq.frames]
    sys_ = System(cfg, cam)
    t = sys_.tracker
    matches, first = [], {}

    def on_frame(i, out):
        matches.append(int((t._cur_depth > 0).sum()))
        if i == 0:
            d = t._cur_depth.cpu().numpy()
            xy = np.round(t.last_feats.xy.cpu().numpy()).astype(int)
            ok = d > 0
            gt = seq.frames[0].depth[xy[ok, 1], xy[ok, 0]]
            first.update(n=int(ok.sum()), err=float(np.median(np.abs(d[ok] - gt))),
                         feats=t.last_feats)

    feed = lambda i, img: sys_.track_stereo(img, rights[i], i / 30.0)  # noqa: E731
    reset_launches()
    states, frame_ms = drive(sys_, images, seq, feed=feed, on_frame=on_frame)
    launches = read_launches()
    depth_asserts("stereo", sys_, states, frame_ms, launches, seq, 2, card)

    left = torch.from_numpy(images[0]).to(dev)
    right = torch.from_numpy(rights[0]).to(dev)
    fl, fr = first["feats"], t.extractor(right)
    args = (fl, fr, left.float(), right.float(), torch.tensor(t.bf, device=dev),
            torch.tensor(t.min_z, device=dev), t.scale_factors, cfg.orb.n_levels)
    st_ms = device_ms(lambda: match_stereo(*args))
    n_l, n_r = int(fl.valid.sum()), int(fr.valid.sum())
    log(f"stereo: frame 0 has {first['n']} stereo matches (of {n_l} left, {n_r} right features), "
        f"median |stereo depth - rendered depth| {first['err']:.5f} m; matches per frame median "
        f"{np.median(matches):.1f} (min {min(matches)}); match_stereo device time at frame 0's "
        f"features ({fl.n} x {fr.n} pairs, {fl.n} x 11 SAD slides) {st_ms:.5f} ms on {card}")
    check(first["n"] >= 80 and first["err"] < 0.15, f"stereo frame 0: {first['n']} matches, "
          f"median depth error {first['err']} m")
    return launches


def phase_compact(dev, card: str) -> dict:
    """Phase 11: a keyframe pool small enough to fill; the per-frame trigger
    compacts it."""
    from weiner_slamit_v2_torch.config import MapCapacityConfig
    from weiner_slamit_v2_torch.tracking.system import System

    n = COMPACT["n_frames"]
    cfg, cam, seq, images = workload(n)
    cfg = cfg.replace(capacity=MapCapacityConfig(max_keyframes=COMPACT["max_keyframes"],
                                                 local_ba_window=COMPACT["local_ba_window"]))
    sys_ = System(cfg, cam)
    t = sys_.tracker
    calls, real = [], sys_.compact

    def compact():
        before = (t.frame_id, t.n_kf_host, int(t.m.kf_valid.sum()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real()
        torch.cuda.synchronize()
        calls.append((*before, t.n_kf_host, round((time.perf_counter() - t0) * 1e3, 3)))

    sys_.compact = compact
    reset_launches()
    states, frame_ms = drive(sys_, images, seq)
    launches = read_launches()
    n_ok = sum(s == "OK" for s in states)
    ate = ok_frames_ate(sys_, states, seq.gt_Twc)
    _, Twc = t.trajectory_Twc()
    init = states.index("OK")
    steady = frame_ms[init + 1:]
    log(f"compact: {COMPACT}, init at frame {init}, {n_ok} OK of {n}, compactions (frame, keyframe "
        f"slots used, valid, slots after, ms) {calls}, keyframe slots used at the end "
        f"{t.n_kf_host}, ATE over OK frames {ate:.5f} m, launches {launches}; median "
        f"{np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} on {card}")
    check(len(calls) >= 1 and sys_.compactions == len(calls), f"no compaction: {calls}")
    check(n_ok > 0.8 * n, f"{n_ok} of {n} frames OK")
    check(np.isfinite(Twc).all(), "non-finite exported pose")
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    check(launches["fast_score_nms"] == n, str(launches))
    return launches


def triangle_texture(h: int, w: int, rng, n: int) -> np.ndarray:
    """n random gray triangles (sides ~6-30 px) on black, in [0, 1]."""
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        P = np.array([rng.integers(0, w), rng.integers(0, h)]) + rng.normal(0, rng.uniform(6, 30), (3, 2))
        (x0, y0), (x1, y1) = np.maximum(np.floor(P.min(0)), 0).astype(int), np.minimum(
            np.ceil(P.max(0)), [w - 1, h - 1]).astype(int)
        (ax, ay), (bx, by), (cx, cy) = P
        d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if x1 <= x0 or y1 <= y0 or abs(d) < 1e-6:
            continue
        Y, X = np.mgrid[y0:y1, x0:x1]
        l1 = ((by - cy) * (X - cx) + (cx - bx) * (Y - cy)) / d
        l2 = ((cy - ay) * (X - cx) + (ax - cx) * (Y - cy)) / d
        img[y0:y1, x0:x1][(l1 >= 0) & (l2 >= 0) & (l1 + l2 <= 1)] = rng.uniform(0, 1)
    return img


def loop_sequence(n_frames: int, radius: float, laps: float, depth: float, seed: int,
                  start_wedge: tuple[float, float]):
    """A circle of ``radius`` over a textured plane at ``depth``, flown
    ``laps`` times (a little over once): the camera comes back to its start
    views after one lap, with the far side of the circle disjoint from the
    start (2 radius against the footprint W / f x depth), so only a loop
    closure can join the two ends. Starts at (-radius, 0), like
    tests/test_loop.py::disjoint_out_and_back, at its speed. The plane is the
    blocky value noise of the other phases, whose views give near-identical
    BoW vectors; the wedge of the circle at ``start_wedge`` (rad from the
    start, in the direction of flight) is textured with triangles over that
    noise instead, so the bag of words tells the start's views from the rest
    and loop detection proposes start keyframes on the revisit."""
    from weiner_slamit_v2_torch.io.datasets import FrameData, Sequence, SyntheticWorld, _perlin_texture

    w = WORKLOAD
    H, W, f = w["H"], w["W"], w["f"]
    _, _, K = bench_config()
    rng = np.random.default_rng(seed)
    ppm = f / depth
    th, tw = int((2 * radius + H / f * depth + 1.0) * ppm), int((2 * radius + W / f * depth + 1.0) * ppm)
    texture = _perlin_texture(th, tw, rng)
    start = 0.7 * triangle_texture(th, tw, rng, th * tw // 400) + 0.3 * _perlin_texture(th, tw, rng) / 255.0
    Y, X = np.mgrid[0:th, 0:tw]
    ang = np.angle(-((X - tw / 2) + 1j * (Y - th / 2)))      # 0 at the start, increasing with flight
    wedge = (ang > start_wedge[0]) & (ang < start_wedge[1])
    texture = np.where(wedge, start / start.max() * 255.0, texture).astype(np.float32)
    world = SyntheticWorld(texture=texture, K=K, plane_depth=depth, pixels_per_meter=ppm)
    frames, gt = [], np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        th = np.pi + 2 * np.pi * laps * i / (n_frames - 1)
        gt[i] = np.eye(4)
        gt[i, :3, 3] = [radius * np.cos(th), radius * np.sin(th), 0.0]
        frames.append(FrameData(timestamp=i / 30.0, image=world.render(np.linalg.inv(gt[i]), H, W)))
    return Sequence(frames=frames, gt_Twc=gt)


def inject_drift(t, n_frames: int) -> int:
    """tests/test_loop.py:196-219: the keyframes of the first ``n_frames``
    frames and the points they created moved by a gauge drift G (0.1 rad
    about y, (0.25, 0.1, 0.15) m). Returns the number of keyframes moved."""
    from weiner_slamit_v2_torch.geometry import se3

    m = t.m
    G = np.eye(4, dtype=np.float32)
    G[:3, 3] = [0.25, 0.1, 0.15]
    c, s = np.cos(0.1), np.sin(0.1)
    G[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    G = torch.from_numpy(G).to(m.device)
    kf_sel = (m.kf_frame_id < n_frames) & (m.kf_frame_id >= 0) & m.kf_valid
    mp_sel = torch.isin(m.mp_first_kf, torch.nonzero(kf_sel).flatten().int()) & m.mp_valid
    t.m = m.replace(kf_pose=torch.where(kf_sel[:, None, None], m.kf_pose @ se3.inv(G)[None], m.kf_pose),
                    mp_pos=torch.where(mp_sel[:, None], se3.apply(G, m.mp_pos), m.mp_pos))
    return int(kf_sel.sum())


class LoopWatch:
    """Host times (card synchronized before and after) of the loop closer's
    stages, per closure attempt, and the global BAs' lifetimes: chunks
    issued, enqueue-to-adoption time, peak device memory in between. The
    patched functions are restored by close()."""

    STAGES = [("matcher", "match_by_descriptor", "bow_match"),
              ("sim3_solver", "ransac_sim3", "ransac"), ("loop_closing", "search_by_sim3", "search_by_sim3"),
              ("sim3_solver", "refine_sim3", "refine"),
              ("loop_closing", "_project_loop_points", "projection_40"),
              ("loop_closing", "_propagate_and_fuse", "propagate_fuse"),
              ("loop_closing", "_search_and_fuse", "search_and_fuse"),
              ("loop_closing", "optimize_pose_graph", "essential_graph")]

    def __init__(self, lc, on_graph=None):
        from weiner_slamit_v2_torch.frontend import matcher
        from weiner_slamit_v2_torch.optim import sim3_solver
        from weiner_slamit_v2_torch.tracking import loop_closing

        self.mods = {"matcher": matcher, "sim3_solver": sim3_solver, "loop_closing": loop_closing}
        self.in_close = False
        self.lc, self.on_graph = lc, on_graph
        self.attempts, self.detect_ms, self.gbas, self.graph_args = [], [], [], None
        self.saved = [(mod, attr, getattr(self.mods[mod], attr)) for mod, attr, _ in self.STAGES]
        for (mod, attr, name), (_, _, fn) in zip(self.STAGES, self.saved):
            setattr(self.mods[mod], attr, self._stage(name, fn))
        self._detect, self._close = lc._detect, lc._close
        self._enqueue, self._poll = lc._enqueue_global_ba, lc.poll_global_ba
        lc._detect, lc._close = self.detect, self.close_attempt
        lc._enqueue_global_ba, lc.poll_global_ba = self.enqueue, self.poll

    @staticmethod
    def _ms(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, round((time.perf_counter() - t0) * 1e3, 3)

    def _stage(self, name, fn):
        def run(*args, **kwargs):
            if not self.in_close:     # the matcher also serves relocalization
                return fn(*args, **kwargs)
            out, ms = self._ms(fn, *args, **kwargs)
            a = self.attempts[-1]
            a[name] = ms
            # what each gate saw: matches, inliers, loop matches
            if name in ("ransac", "refine"):
                a[name + "_inliers"] = int(out[2])
            elif name in ("bow_match", "search_by_sim3", "projection_40"):
                a[name + "_matches"] = int(((out[0] if name == "bow_match" else out) >= 0).sum())
            if name == "essential_graph":
                if self.graph_args is None:
                    self.graph_args = (args, kwargs)
                if self.on_graph is not None:
                    self.on_graph(args, kwargs, out)
            return out
        return run

    def detect(self, kf_id):
        out, ms = self._ms(self._detect, kf_id)
        self.detect_ms.append((kf_id, ms))
        return out

    def close_attempt(self, kf_id, cand):
        self.attempts.append(dict(kf=kf_id, cand=cand, detect=self.detect_ms[-1][1]))
        self.in_close = True
        try:
            ok, ms = self._ms(self._close, kf_id, cand)
        finally:
            self.in_close = False
        self.attempts[-1].update(closed=ok, close_total=ms)
        return ok

    def enqueue(self, gauge_kf):
        if self.gbas and self.gbas[-1]["adopted_ms"] is None:
            self.gbas[-1]["superseded"] = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        issued = self.lc.gba_chunks_issued
        self._enqueue(gauge_kf)
        self.gbas.append(dict(t0=t0, issued0=issued, base=base, adopted_ms=None, superseded=False))

    def poll(self, force: bool = False):
        adopted = self._poll(force)
        if adopted:
            torch.cuda.synchronize()
            g = self.gbas[-1]
            g.update(adopted_ms=round((time.perf_counter() - g["t0"]) * 1e3, 3),
                     chunks=self.lc.gba_chunks_issued - g["issued0"],
                     peak_bytes=torch.cuda.max_memory_allocated(), base_bytes=g["base"])
        return adopted

    def close(self):
        for mod, attr, fn in self.saved:
            setattr(self.mods[mod], attr, fn)
        lc = self.lc
        del lc._detect, lc._close, lc._enqueue_global_ba, lc.poll_global_ba

    def closures(self):
        return [{k: v for k, v in a.items() if k != "closed"} for a in self.attempts if a["closed"]]


def phase_loop(dev, card: str) -> dict:
    """Phase 12: monocular loop closure at full width."""
    from weiner_slamit_v2_torch.config import LoopConfig, TrackingConfig
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse
    from weiner_slamit_v2_torch.optim.ba_extract import extract_global_ba
    from weiner_slamit_v2_torch.optim.local_ba import ba_finalize, ba_phase1, ba_phase2_chunk
    from weiner_slamit_v2_torch.optim.pose_graph import optimize_pose_graph
    from weiner_slamit_v2_torch.tracking.system import System

    L = LOOP
    cfg, cam, _ = bench_config()
    cfg = cfg.replace(tracking=TrackingConfig(), loop=LoopConfig())
    seq = loop_sequence(L["n_frames"], L["radius"], L["laps"], L["depth"], L["seed"], L["start_wedge"])
    images = [uint8(fr.image) for fr in seq.frames]
    sys_ = System(cfg, cam, enable_loop_closing=True)
    t, lc = sys_.tracker, sys_.loop_closer
    check(not lc.fix_scale and sys_.device.type == "cuda", "monocular loop closer on the card")

    def traj_ate(n=None):
        """Scale-aligned ATE of the first n trajectory entries (all: None),
        each against the ground truth of its own frame."""
        ts, Twc = t.trajectory_Twc()
        idx = np.rint(np.asarray(ts[:n]) * 30.0).astype(int)     # timestamps are i / 30
        return ate_rmse(Twc[:n], seq.gt_Twc[idx]), len(idx)

    watch = LoopWatch(lc)
    ate_pre, n_pre, moved, first_close, inliers = [None], [None], [0], [None], []

    def on_frame(i, out):
        inliers.append((out.n_inliers, int(t.m.kf_valid.sum())))
        if i == L["apex"]:
            sys_.finish()
            moved[0] = inject_drift(t, L["drift_frames"])
        if lc.n_loops_closed and first_close[0] is None:
            first_close[0] = i
        if i > L["eval_from"] and lc.n_loops_closed == 0:
            ate_pre[0], n_pre[0] = traj_ate()

    reset_launches()
    try:
        states, frame_ms = drive(sys_, images, seq, on_frame=on_frame)
    finally:
        watch.close()
    launches = read_launches()
    # the closure and the global BA correct the frames tracked before it;
    # the frames after it are not part of the comparison
    ate_post, _ = traj_ate(n_pre[0])
    ate_all, n_all = traj_ate()
    m = sys_.map
    poses = m.kf_pose[m.kf_valid]
    R = poses[:, :3, :3]
    ortho = float((R @ R.transpose(-1, -2) - torch.eye(3, device=dev)).abs().max())
    init = states.index("OK")
    steady = frame_ms[init + 1:]
    closures = watch.closures()
    adopted = [g for g in watch.gbas if g["adopted_ms"] is not None]
    frame_of = m.kf_frame_id.tolist()
    log(f"loop: {L}, {cfg.loop}; init at frame {init}, {sum(s == 'OK' for s in states)} OK "
        f"of {len(states)}, LOST frames {[i for i, s in enumerate(states) if s == 'LOST']}; drift moved "
        f"{moved[0]} keyframes; keyframes created {t.n_kf_host} (valid {sys_.n_keyframes()}), points "
        f"{sys_.n_map_points()}, staged passes {sys_.staged_passes}; loops closed {lc.n_loops_closed} "
        f"(first on frame {first_close[0]}), closure attempts {len(watch.attempts)}, loop edges (loop "
        f"keyframe, its frame; current keyframe, its frame) "
        f"{[(i, frame_of[i], j, frame_of[j]) for i, j, _ in lc.loop_edges]}; ATE of the {n_pre[0]} frames tracked before the first closure: "
        f"{ate_pre[0]} m just before it, {ate_post:.5f} m after finish(); ATE of all {n_all} frames "
        f"after finish() {ate_all:.5f} m; largest |R R^T - I| {ortho:.2e}; resets {t.resets}; launches "
        f"{launches}; per frame (inliers, valid keyframes) {inliers}")
    log(f"loop: median {np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} ms/frame, max "
        f"{max(steady):.3f} ms; detect ms per keyframe median "
        f"{np.median([ms for _, ms in watch.detect_ms]) if watch.detect_ms else 0:.3f} "
        f"({len(watch.detect_ms)} calls) on {card}")
    for c in closures:
        log(f"loop closure stage ms (host clock, card synchronized): {c}")
    for g in watch.gbas:
        log(f"loop global BA: chunks issued {g.get('chunks')}, superseded {g['superseded']}, enqueue to "
            f"adoption {g['adopted_ms']} ms, peak device memory {g.get('peak_bytes')} B (allocated at "
            f"enqueue {g['base']} B)")

    # the essential graph of the first closure, device time; the global BA
    # alone on the final map, host time synchronized and peak memory
    if watch.graph_args is not None:
        args, kwargs = watch.graph_args
        try:
            pg_ms, how = device_ms(lambda: optimize_pose_graph(*args, **kwargs), reps=3, loops=3), "graph replay"
        except RuntimeError as e:   # a solver that cannot be captured: timed by events
            log(f"loop: optimize_pose_graph not capturable ({str(e).splitlines()[0]})")
            pg_ms, how = eager_ms(lambda: optimize_pose_graph(*args, **kwargs), reps=3, loops=3), "events"
        log(f"loop: optimize_pose_graph device time {pg_ms:.5f} ms ({how}; {int(args[1].sum())} valid of "
            f"{args[0].shape[0]} keyframe slots, {args[3].shape[0]} edges, {kwargs}) on {card}")
    gauge = int(torch.nonzero(m.kf_valid)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prob, _, _ = extract_global_ba(m, t.K, t.inv_sigma2, gauge_kf=gauge)
    cam_pose, points, lam, inlier = ba_phase1(prob, n_iters=5)
    for _ in range(-(-(cfg.optim.global_ba_iters - 5) // cfg.tracking.ba_chunk_iters)):
        cam_pose, points, lam = ba_phase2_chunk(prob, cam_pose, points, lam, inlier,
                                                n_iters=cfg.tracking.ba_chunk_iters)
    res = ba_finalize(prob, cam_pose, points)
    torch.cuda.synchronize()
    gba_ms = (time.perf_counter() - t0) * 1e3
    log(f"loop: global BA alone on the final map ({prob.cam_pose.shape[0]} camera slots, "
        f"{prob.points.shape[0]} point slots x {prob.obs_cam.shape[1]} observations; {int(m.kf_valid.sum())} "
        f"keyframes, {int(m.mp_valid.sum())} points valid): {gba_ms:.3f} ms host time synchronized, peak "
        f"device memory {torch.cuda.max_memory_allocated()} B ({base} B allocated before), final cost "
        f"{float(res.final_cost):.4f} on {card}")

    check(lc.n_loops_closed >= 1, f"no loop closed: attempts {watch.attempts}")
    check(ate_pre[0] is not None and np.isfinite(ate_post) and ate_post < ate_pre[0],
          f"ATE of the frames before the closure, after finish() {ate_post} !< before {ate_pre[0]}")
    check(launches["fast_score_nms"] == len(images), f"{launches}, want A once per frame")
    check(launches["windowed_best2"] >= sys_.staged_passes >= sys_.mapping_passes > 0,
          f"{launches}, passes {sys_.staged_passes}")
    check(bool(torch.isfinite(poses).all()) and ortho < 1e-4, f"keyframe poses: |R R^T - I| {ortho}")
    check(lc._pending_gba is None and adopted and all(g["chunks"] == 1 + -(-(cfg.optim.global_ba_iters - 5)
                                                                         // cfg.tracking.ba_chunk_iters)
                                                        for g in adopted),
          f"global BAs {watch.gbas}")
    check(bool(torch.isfinite(res.cam_pose).all()), "global BA alone: non-finite poses")
    LOOP_RUN.update(sys=sys_, seq=seq, states=states)
    return launches


def phase_stereo_loop(dev, card: str) -> dict:
    """Phase 13: phase 10 with loop closing on (fix_scale)."""
    from weiner_slamit_v2_torch.geometry import sim3
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(DEPTH_FRAMES, cam=dict(baseline_times_fx=BF,
                                     depth_threshold=DEPTH_THRESHOLD), seq=STEREO_SEQ)
    cfg = cfg.replace(sensor="stereo")
    rights = [uint8(fr.image_right) for fr in seq.frames]
    sys_ = System(cfg, cam, enable_loop_closing=True)
    lc = sys_.loop_closer
    check(lc.fix_scale, "stereo loop closer without fix_scale")
    scale_dev = []

    def on_graph(args, kwargs, S_opt):
        valid = args[1]
        check(kwargs.get("fix_scale") is True, f"essential graph without fix_scale: {kwargs}")
        scale_dev.append(max(float((sim3.scale_of(S_opt[valid]) - 1).abs().max()),
                             float((sim3.scale_of(args[5]) - 1).abs().max())))

    watch = LoopWatch(lc, on_graph)
    feed = lambda i, img: sys_.track_stereo(img, rights[i], i / 30.0)  # noqa: E731
    reset_launches()
    try:
        states, frame_ms = drive(sys_, images, seq, feed=feed)
    finally:
        watch.close()
    launches = read_launches()
    depth_asserts("stereo+loop", sys_, states, frame_ms, launches, seq, 2, card)
    log(f"stereo+loop: loops closed {lc.n_loops_closed}, closure attempts {len(watch.attempts)}, detections "
        f"{len(watch.detect_ms)}, closures {watch.closures()}, global BAs {watch.gbas}, largest |scale - 1| "
        f"over each closure's edges and poses {scale_dev} on {card}")
    check(all(d <= 1e-6 for d in scale_dev) and len(scale_dev) == lc.n_loops_closed,
          f"a closure moved a scale: {scale_dev}")
    if not scale_dev:
        log("stereo+loop: no loop closed, so no Sim3 scale was checked on the card (fix_scale is "
            "held by the CPU tests)")
    return launches


def world_one_mesh(dev):
    """A world-size-1 NCCL group on a file store (created once; phases 14
    and 16 share it) and the BAMesh over it."""
    import tempfile

    from weiner_slamit_v2_torch.parallel import multihost

    if not dist.is_initialized():
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        multihost.initialize(dev, init_method=f"file://{store}/store", world_size=1, rank=0)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"backend {dist.get_backend()}, world size {dist.get_world_size()}")
    return multihost.global_mesh(dev)


def phase_gba(dev, card: str) -> dict:
    """Phase 14: System.distributed_gba at full width on phase 12's map."""
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse
    from weiner_slamit_v2_torch.optim.local_ba import solve_ba
    from weiner_slamit_v2_torch.parallel import sharded_ba

    sys_, seq, states = LOOP_RUN["sys"], LOOP_RUN["seq"], LOOP_RUN["states"]
    t = sys_.tracker
    sys_.finish()
    mesh = world_one_mesh(dev)

    def ok_ate():
        """Scale-aligned ATE of the trajectory entries of OK frames, each
        against its own frame (timestamps are i / 30); phase 12 may lose
        its track after the closure (ROADMAP C), and a LOST entry repeats a
        stale pose."""
        ts, Twc = t.trajectory_Twc()
        idx = np.rint(np.asarray(ts) * 30.0).astype(int)
        sel = np.asarray([states[i] == "OK" for i in idx])
        return ate_rmse(Twc[sel], seq.gt_Twc[idx[sel]]), int(sel.sum())

    # tests/test_parallel.py:232-239: every non-gauge keyframe's translation
    # and every valid point moved by seeded N(0, 0.01)
    m = t.m
    gauge = int(torch.nonzero(m.kf_valid)[0])
    ate_phase12, n_ok = ok_ate()
    rng = np.random.default_rng(3)
    nkf = m.kf_pose.shape[0]
    noise_t = torch.from_numpy(rng.normal(0, 0.01, (nkf, 3)).astype(np.float32)).to(dev)
    move = ((torch.arange(nkf, device=dev) != gauge) & m.kf_valid)[:, None]
    pose = m.kf_pose.clone()
    pose[:, :3, 3] += torch.where(move, noise_t, 0.0)
    noise_p = torch.from_numpy(rng.normal(0, 0.01, tuple(m.mp_pos.shape)).astype(np.float32)).to(dev)
    t.m = m.replace(kf_pose=pose, mp_pos=m.mp_pos + noise_p * m.mp_valid[:, None])
    ate_before, _ = ok_ate()

    # the timed call; its sharded solve is wrapped to time it and to keep the
    # problem it was given (at world size 1 the whole extraction)
    solved, real_solve = [], sharded_ba.solve_ba_sharded

    def timed_solve(prob, *args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real_solve(prob, *args, **kwargs)
        torch.cuda.synchronize()
        solved.append((prob, (time.perf_counter() - t1) * 1e3))
        return out

    # the group's first collective sets up NCCL's communicator: done here,
    # outside the timed call and its all_reduce count
    dist.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    reset_launches()
    calls0 = mesh.all_reduces
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sharded_ba.solve_ba_sharded = timed_solve
    try:
        t0 = time.perf_counter()
        res = sys_.distributed_gba(mesh, iters=20)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        sharded_ba.solve_ba_sharded = real_solve
    peak = torch.cuda.max_memory_allocated()
    calls = mesh.all_reduces - calls0
    launches = read_launches()
    ate_after, _ = ok_ate()
    poses = t.m.kf_pose[t.m.kf_valid]
    R = poses[:, :3, :3]
    ortho = float((R @ R.transpose(-1, -2) - torch.eye(3, device=dev)).abs().max())

    # the adopted result against solve_ba on the problem that call solved,
    # and two solve_ba runs against each other (the run-to-run spread: 0
    # with util.index_add's ordered sums)
    (prob, solve_ms), = solved
    cams, pts = prob.cam_valid, prob.point_valid

    def diff(a, b):
        return (float((a.cam_pose - b.cam_pose)[cams].abs().max()),
                float((a.points - b.points)[pts].abs().max()))

    ref = solve_ba(prob, 5, 15)
    d_pose, d_pts = diff(res, ref)
    spread = diff(ref, solve_ba(prob, 5, 15))
    log(f"distributed GBA: {prob.cam_pose.shape[0]} camera slots ({int(cams.sum())} valid), "
        f"{prob.points.shape[0]} point slots ({int(pts.sum())} valid) x {prob.obs_cam.shape[1]} "
        f"observations, 20 LM steps over NCCL, world size {mesh.world_size} (no scaling measured): "
        f"distributed_gba {ms:.3f} ms host time with the card synchronized, of it the sharded solve "
        f"{solve_ms:.3f} ms; {calls} all_reduce calls; peak device memory {peak} B ({base} B "
        f"allocated before); scale-aligned ATE of the {n_ok} OK frames {ate_phase12:.5f} m after phase "
        f"12, {ate_before:.5f} m perturbed, {ate_after:.5f} m after; the adopted result against "
        f"solve_ba(5, 15) on the problem it solved: poses {d_pose:.3e}, points {d_pts:.3e}; two "
        f"solve_ba runs part by poses {spread[0]:.3e}, points {spread[1]:.3e}; final cost "
        f"{float(res.final_cost):.4f}; largest |R R^T - I| {ortho:.2e} on {card}")
    check(mesh.world_size == 1 and calls == 2 * 20 + 1, f"world size {mesh.world_size}, {calls} calls")
    check(np.isfinite(ate_after) and ate_after < ate_before, f"ATE {ate_before} -> {ate_after}")
    check(d_pose <= 1e-3 and d_pts <= 1e-2, f"against solve_ba: poses {d_pose}, points {d_pts}")
    check(spread == (0.0, 0.0), f"two solve_ba runs part: poses {spread[0]}, points {spread[1]}")
    check(bool(torch.isfinite(poses).all()) and ortho < 1e-4, f"keyframe poses: |R R^T - I| {ortho}")
    check(t.m.kf_pose.is_cuda and res.cam_pose.is_cuda, "the adopted map left the card")
    return launches


def phase_posenet(dev, card: str) -> dict:
    """Phase 15: phase 5's run with the PoseNet head on every frame."""
    import copy

    from weiner_slamit_v2_torch.io.evaluation import ate_rmse
    from weiner_slamit_v2_torch.models import posenet
    from weiner_slamit_v2_torch.tracking.system import System

    cfg, cam, seq, images = workload(POSENET_FRAMES, abortable_ba=False)
    sys_ = System(cfg, cam)
    t = sys_.tracker
    t.enable_posenet()
    net = t.posenet
    check(next(net.parameters()).is_cuda, "the head is not on the card")
    bad = []

    def on_frame(i, out):
        pos, scores, keep = t.last_person
        ok = (pos.is_cuda and tuple(pos.shape) == (17, 2) and tuple(scores.shape) == (17,)
              and tuple(keep.shape) == (17,) and bool(torch.isfinite(pos).all())
              and bool(((scores >= 0) & (scores <= 1)).all()))
        if not ok:
            bad.append(i)

    reset_launches()
    states, frame_ms = drive(sys_, images, seq, on_frame=on_frame)
    launches = read_launches()
    init = next((i for i, s in enumerate(states) if s == "OK"), None)
    check(init is not None, f"never initialized: {states}")
    _, Twc = t.trajectory_Twc()
    ate = ate_rmse(Twc, seq.gt_Twc[-len(Twc):])
    steady = frame_ms[init + 1:]

    # one frame's heads on the card against the same module on the CPU
    img = torch.from_numpy(images[POSENET_FRAMES // 2]).to(dev)
    x = (posenet.resize_to_input(img)[None] / 127.5 - 1.0)
    with torch.no_grad():
        hm_dev = net(x)[0][0].reshape(-1, 17)
        hm_cpu = copy.deepcopy(net).cpu()(x.cpu())[0][0].reshape(-1, 17)
    tol = 1e-5
    err = float((hm_dev.cpu() - hm_cpu).abs().max())
    top2 = hm_cpu.topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > tol
    cells_equal = bool((hm_dev.argmax(0).cpu() == hm_cpu.argmax(0))[clear].all())
    head = lambda: posenet.person_keypoints_for_frame(net, img)  # noqa: E731
    try:
        head_ms, how = device_ms(head), "graph replay"
    except RuntimeError as e:   # not capturable: timed by events around eager calls
        log(f"posenet: the head is not capturable ({str(e).splitlines()[0]})")
        head_ms, how = eager_ms(head), "events"
    log(f"posenet: init at frame {init}, {sum(s == 'OK' for s in states[init:])} OK of "
        f"{POSENET_FRAMES - init}, ATE {ate:.5f} m, launches {launches}, mapping passes "
        f"{sys_.mapping_passes}; heatmaps card vs CPU max |diff| {err:.3e} (tolerance {tol}), argmax "
        f"cells equal where the top-two margin > {tol}: {cells_equal} ({int(clear.sum())} of 17 "
        f"keypoints); person_keypoints_for_frame device time {head_ms:.5f} ms per frame ({how})")
    log(f"posenet: median {np.median(steady):.3f} ms/frame, p90 {np.percentile(steady, 90):.3f} "
        f"ms/frame with the head (phase 5 without it: median {SLICE_MS.get('median', float('nan')):.3f}, "
        f"p90 {SLICE_MS.get('p90', float('nan')):.3f}) on {card}")
    check(not bad, f"last_person not finite (17, 2)/(17,)/(17,) on the card on frames {bad}")
    check(all(s == "OK" for s in states[init:]), f"lost after init: {states}")
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    check(err <= tol and cells_equal, f"heatmaps card vs CPU {err}, cells equal {cells_equal}")
    check(launches["fast_score_nms"] == POSENET_FRAMES, f"{launches}, want A once per frame")
    check(launches["windowed_best2"] >= sys_.mapping_passes > 0, f"{launches}, passes {sys_.mapping_passes}")
    return launches


def phase_extract(dev, card: str) -> dict:
    """Phase 16: batched and sharded extraction of 8 full-width frames."""
    from weiner_slamit_v2_torch.frontend.extractor import OrbExtractor
    from weiner_slamit_v2_torch.parallel.data_parallel import batched_extract, sharded_extract

    cfg, _, _, images = workload(8)
    ex = OrbExtractor(cfg.orb, (WORKLOAD["H"], WORKLOAD["W"]))
    frames = torch.from_numpy(np.stack(images)).to(dev)
    mesh = world_one_mesh(dev)
    per = [ex(f) for f in frames]
    fields = list(vars(per[0]))
    out = {}
    reset_launches()
    for name, fn in (("batched", lambda: batched_extract(ex, frames)),
                     ("sharded", lambda: sharded_extract(ex, frames, mesh))):
        before = read_launches()["fast_score_nms"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = read_launches()["fast_score_nms"] - before
        same = all(torch.equal(getattr(got, k), torch.stack([getattr(p, k) for p in per])) for k in fields)
        out[name] = (same, n, ms)
        log(f"extract {name}: 8 frames {WORKLOAD['W']}x{WORKLOAD['H']}, equal to per-frame extraction bit for bit: {same}; "
            f"kernel A launches {n}; {ms:.3f} ms host time synchronized (world size {mesh.world_size}) "
            f"on {card}")
    check(all(same and n == 8 for same, n, _ in out.values()), f"batched/sharded extraction {out}")
    return read_launches()


def phase_mapping_device(dev, card: str) -> dict:
    """Phase 17: tracking on the card, the mapping pass on the CPU."""
    from weiner_slamit_v2_torch.config import (CameraConfig, MapCapacityConfig, OrbConfig,
                                               SlamConfig)
    from weiner_slamit_v2_torch.geometry.camera import Camera
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_torch.tracking.system import System

    H, W, f, n = 240, 320, 250.0, 40
    cfg = SlamConfig(orb=OrbConfig(n_features=512),
                     camera=CameraConfig(fx=f, fy=f, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0,
                                         k3=0, width=W, height=H),
                     capacity=MapCapacityConfig(max_keyframes=64, max_map_points=4096))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    seq = make_synthetic_sequence(n_frames=n, h=H, w=W, K=K, seed=0, motion="orbit",
                                  motion_frames=WORKLOAD["motion_frames"])
    images = [uint8(fr.image) for fr in seq.frames]
    sys_ = System(cfg, Camera.create(f, f, W / 2, H / 2, width=W, height=H), device="cuda",
                  mapping_device="cpu")
    check(sys_.mapping_device.type == "cpu" and sys_.tracker.m.kf_pose.is_cuda, "devices")
    reset_launches()
    states, frame_ms = drive(sys_, images, seq)
    launches = read_launches()
    init = next((i for i, s in enumerate(states) if s == "OK"), None)
    check(init is not None, f"never initialized: {states}")
    m = sys_.tracker.m
    log(f"mapping device: tracking on {sys_.device}, mapping on {sys_.mapping_device}; init at frame "
        f"{init}, {sum(s == 'OK' for s in states[init:])} OK of {n - init}, staged passes "
        f"{sys_.staged_passes}, adopted {sys_.mapping_passes}, map on {m.kf_pose.device}, launches "
        f"{launches}; median {np.median(frame_ms[init + 1:]):.3f} ms/frame, max {max(frame_ms):.3f} "
        f"ms (the mapping pass on this machine's CPU: not a performance figure) on {card}")
    check(all(s == "OK" for s in states[init:]), f"lost after init: {states}")
    check(sys_.mapping_passes > 0, "no mapping pass adopted")
    check(all(getattr(m, k).is_cuda for k in vars(m)), "the adopted map is not on the card")
    check(launches["fast_score_nms"] == n, f"{launches}, want A once per frame")
    return launches


def phase_cli(dev, card: str) -> dict:
    """Phase 18: the CLI on the card, in a subprocess."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        traj, ckpt = os.path.join(d, "traj.txt"), os.path.join(d, "map.npz")
        cmd = [sys.executable, "-m", "weiner_slamit_v2_torch.cli", "--dataset", "synthetic",
               "--frames", "40", "--eval", "--posenet", "--out", traj, "--checkpoint", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-3000:]}")
        summary = json.loads(r.stdout.strip().splitlines()[-1])
        log(f"cli: {' '.join(cmd[1:5])} ... exit 0 in {wall:.1f} s (process start and kernel "
            f"loading included); summary {json.dumps(summary)}; trajectory {os.path.getsize(traj)} B, "
            f"checkpoint {os.path.getsize(ckpt)} B on {card}")
        check(summary.get("device", "").startswith("cuda"), f"CLI ran on {summary.get('device')}")
        check(summary["tracked_ok"] > 20 and "ate_rmse" in summary, str(summary))
        check(os.path.getsize(traj) > 0 and os.path.getsize(ckpt) > 0, "outputs empty")
    return {}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import weiner_slamit_v2_torch  # noqa: F401  (sets the TF32-off policy)
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    global _v1
    t0 = time.perf_counter()
    v1_srcs = cuda_build.sources("v1")
    cuda_build.build(cuda_build.sources() + v1_srcs)   # one nvcc each, all at once
    cuda_build.lib()
    _v1 = cuda_build.load(v1_srcs, V1_SIGNATURES)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {cuda_build.build_seconds} s)")
    for line in cuda_build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    frame = uint8(make_synthetic_sequence(n_frames=2, h=480, w=640, seed=0, motion="orbit")
                  .frames[1].image)
    kern_a = phase_kernel_a(frame, dev)
    phase_kernel_b(dev)
    want = {int(a) for a in sys.argv[1:]} or set(range(7, 19))
    if 14 in want:
        want.add(12)   # phase 14 runs on phase 12's map
    launches, captured = phase_slice(dev, card)
    kern_b = phase_kernel_b_fuse(captured, dev)
    paths = [(7, "reloc", phase_reloc), (8, "reset", lambda d, c: phase_reset(d)),
             (9, "rgbd", phase_rgbd), (10, "stereo", phase_stereo), (11, "compact", phase_compact),
             (12, "loop", phase_loop), (13, "stereo_loop", phase_stereo_loop),
             (14, "distributed_gba", phase_gba), (15, "posenet", phase_posenet),
             (16, "extract", phase_extract), (17, "mapping_device", phase_mapping_device),
             (18, "cli", phase_cli)]
    by_path = {"slice": launches}
    for num, name, phase in paths:
        if num in want:
            t0 = time.perf_counter()
            by_path[name] = phase(dev, card)
            log(f"phase {num} ({name}): {time.perf_counter() - t0:.1f} s")
    log(f"kernel launches by path (each read from zero; phase 18's are in its own process): {by_path}")
    if dist.is_initialized():
        dist.destroy_process_group()
    kernels = [kern_a, kern_b]
    for k in kernels:
        k["launches"] = sum(p.get(k["name"], 0) for p in by_path.values())
        log(f"kernel {k['name']} on {card}: v1 design {k['v1_ms']:.5f} ms, this design "
            f"{k['ms']:.5f} ms, plain {k['plain_ms']:.5f} ms, bound {k['bound_ms']:.5f} ms "
            f"({k['bound_by']}), share of the bound {k['bound_ms'] / k['ms']:.4f}, "
            f"launches over the phases {k['launches']} (on the slice {launches[k['name']]})")
    torch.cuda.synchronize()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
