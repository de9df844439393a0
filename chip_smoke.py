"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit code):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from weiner_slamit_v2_torch/csrc with nvcc;
  3. kernel A (fused FAST + NMS) against its plain version at the 8
     pyramid-level shapes of a 640x480 frame: bit-exact, plus median times;
  4. kernel B (gated windowed Hamming best/second) against its plain version
     at the fuse shape (20 targets x 1024 x 1024, chi2 gate on) and at a
     ragged shape without the gate: exact, plus median times;
  5. the monocular slice: System.track_monocular over 120 synthetic 640x480
     frames, 1024 features, local mapping on; asserts initialization, OK
     tracking from then on, keyframe and mapping-pass counts, the kernels'
     launch counts on that run, and the scale-aligned ATE.
Prints a JSON line of kernel results, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 120
ATE_BOUND_M = 0.06


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


def median_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn() over reps launches (after warmup)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel_a(frame: np.ndarray, dev) -> dict:
    from weiner_slamit_v2_torch.ops import pyramid
    from weiner_slamit_v2_torch.ops.fast_kernel import fast_score_nms, fast_score_nms_plain

    levels = pyramid.build_pyramid(torch.from_numpy(frame).to(dev).float(), 8, 1.2)
    ms = plain_ms = 0.0
    err = 0.0
    for lvl, img in enumerate(levels):
        img = img.contiguous()
        out = fast_score_nms(img)
        ref = fast_score_nms_plain(img)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"kernel A != plain at level {lvl} {tuple(img.shape)}: "
                                 f"{int((out != ref).sum())} pixels differ")
        err = max(err, float((out - ref).abs().max()))
        k_ms = median_ms(lambda: fast_score_nms(img))
        p_ms = median_ms(lambda: fast_score_nms_plain(img))
        ms += k_ms
        plain_ms += p_ms
        log(f"kernel A level {lvl} {tuple(img.shape)}: equal, corners={int((out > 0).sum())}, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return dict(name="fast_score_nms", route="cuda",
                source="weiner_slamit_v2_torch/csrc/fast_score_nms.cu",
                replaces="weiner_slamit_v2_tpu/ops/fast_pallas.py:123",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def kernel_b_inputs(B: int, N1: int, N2: int, seed: int, dev):
    """Random kernel-B inputs; every row's predicted position lies within a
    few pixels of some column, as projected map points do in the fuse."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    lo = rng.integers(0, 6, (B, N1)).astype(np.int32)
    xy2 = rng.uniform(0, 640, (B, N2, 2)).astype(np.float32)
    near = np.take_along_axis(xy2, rng.integers(0, N2, (B, N1, 1)), axis=1)
    pred = (near + rng.normal(0, 2.0, (B, N1, 2))).astype(np.float32)
    return (
        t(rng.integers(0, 2**32, (B, N1, 8), dtype=np.uint32).view(np.int32)),
        t(rng.integers(0, 2**32, (B, N2, 8), dtype=np.uint32).view(np.int32)),
        t(rng.random((B, N1)) > 0.1), t(rng.random((B, N2)) > 0.1),
        t(pred), t(xy2),
        t(rng.uniform(3, 60, (B, N1)).astype(np.float32)),
        t(lo), t(lo + 1), t(rng.integers(0, 8, (B, N2)).astype(np.int32)),
        t(rng.uniform(0.2, 1.0, (B, N2)).astype(np.float32)),
    )


def phase_kernel_b(dev) -> dict:
    from weiner_slamit_v2_torch.ops.match_kernel import windowed_best2, windowed_best2_plain

    result = None
    for (B, N1, N2, th) in [(20, 1024, 1024, 5.991), (3, 1000, 777, 0.0)]:
        args = kernel_b_inputs(B, N1, N2, seed=B + N2, dev=dev)
        out = windowed_best2(*args, th)
        ref = windowed_best2_plain(*args, th)
        torch.cuda.synchronize()
        for name, a, b in zip(("best_idx", "best_dist", "second_dist"), out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel B {name} != plain at {(B, N1, N2)}: "
                                     f"{int((a != b).sum())} entries differ")
        n_match = int((out[1] < 10_000).sum())
        k_ms = median_ms(lambda: windowed_best2(*args, th))
        p_ms = median_ms(lambda: windowed_best2_plain(*args, th))
        log(f"kernel B {(B, N1, N2)} chi2_th={th}: equal, rows with a candidate={n_match}, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if result is None:   # the main path's shape
            result = dict(name="windowed_best2", route="cuda",
                          source="weiner_slamit_v2_torch/csrc/windowed_best2.cu",
                          replaces="weiner_slamit_v2_tpu/ops/match_pallas.py:157",
                          max_abs_err=0.0, ms=k_ms, plain_ms=p_ms)
    return result


def phase_slice(dev, card: str) -> dict:
    from weiner_slamit_v2_torch.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig
    from weiner_slamit_v2_torch.geometry.camera import Camera
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_torch.io.evaluation import ate_rmse
    from weiner_slamit_v2_torch.ops import fast_kernel, match_kernel
    from weiner_slamit_v2_torch.tracking.system import System

    H, W, f = 480, 640, 500.0
    K = np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=1024),
        camera=CameraConfig(fx=f, fy=f, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=W, height=H),
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=1, abortable_ba=False),
    )
    seq = make_synthetic_sequence(n_frames=N_FRAMES, h=H, w=W, seed=0, motion="orbit", K=K,
                                  motion_frames=164)
    images = [np.clip(fr.image, 0, 255).astype(np.uint8) for fr in seq.frames]
    sys_ = System(cfg, Camera.create(f, f, 320.0, 240.0, width=W, height=H), device=dev)

    fast_kernel.launches = 0
    match_kernel.launches = 0
    states, frame_ms = [], []
    for img, fr in zip(images, seq.frames):
        t0 = time.perf_counter()
        out = sys_.track_monocular(img, fr.timestamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(out.state)
    sys_.finish()
    torch.cuda.synchronize()
    launches = {"fast_score_nms": fast_kernel.launches, "windowed_best2": match_kernel.launches}

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
    check(all(s == "OK" for s in states[init:]), f"lost after init: {states}")
    check(n_created >= 8, f"only {n_created} keyframes created")
    check(n_pass >= 4, f"only {n_pass} adopted mapping passes")
    check(launches["fast_score_nms"] == 8 * N_FRAMES, str(launches))
    check(launches["windowed_best2"] >= n_pass, str((launches, n_pass)))
    check(np.isfinite(Twc).all() and Twc.shape == (N_FRAMES - init, 4, 4), str(Twc.shape))
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")
    return launches


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
    t0 = time.perf_counter()
    cuda_build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {cuda_build.build_seconds} s)")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    frame = np.clip(make_synthetic_sequence(n_frames=2, h=480, w=640, seed=0, motion="orbit")
                    .frames[1].image, 0, 255).astype(np.uint8)
    kernels = [phase_kernel_a(frame, dev), phase_kernel_b(dev)]
    launches = phase_slice(dev, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    torch.cuda.synchronize()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
