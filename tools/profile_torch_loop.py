"""Where a loop closure's two solvers spend their time on one GPU.

    python3 tools/profile_torch_loop.py [--host-bottom-row] [--out FILE]

Runs weiner_slamit_v2_torch's ``optimize_pose_graph`` (the essential graph:
256 keyframe slots, 42 valid, a chain, covisibility edges and one loop edge,
198 edges, 20 LM steps) and ``refine_sim3`` (1024 match slots, 256 valid, 10
GN steps), the sizes of chip_smoke.py phase 12's closure, and prints for
each: host ms with the card synchronized, device ms of a CUDA-graph replay
(or why the call cannot be captured), and a torch.profiler count of kernel
launches, host-to-device copies and stream synchronizations per call, with
the device's busy share and the top operators. --host-bottom-row builds the
bottom row of every 4x4 from a host list (the form of ``se3.from_rt``
before it was made on the device), to measure what that copy costs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_inputs(dev, K=256, n_valid=42, seed=0):
    """Sim3 poses on a circle with noise; edges: the chain, covisibility
    (k, k + 2..5) and the loop (0, n_valid - 1), measured from the truth."""
    from weiner_slamit_v2_torch.geometry import sim3

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_valid, endpoint=False)
    xi = np.zeros((K, 7), np.float32)
    xi[:n_valid, 0], xi[:n_valid, 2], xi[:n_valid, 4] = 2.4 * np.cos(th), 2.4 * np.sin(th), th
    truth = sim3.exp(torch.from_numpy(xi).to(dev))
    noisy = sim3.exp(torch.from_numpy(rng.normal(0, 0.02, (K, 7)).astype(np.float32)).to(dev)) @ truth
    pairs = [(k, k + d) for d in (1, 2, 3, 4, 5) for k in range(n_valid - d)][:197] + [(0, n_valid - 1)]
    ei = torch.tensor([i for i, _ in pairs], dtype=torch.int32, device=dev)
    ej = torch.tensor([j for _, j in pairs], dtype=torch.int32, device=dev)
    S_ji = truth[ej.long()] @ sim3.inv(truth[ei.long()])
    valid = torch.arange(K, device=dev) < n_valid
    fixed = torch.arange(K, device=dev) == 0
    return (noisy, valid, fixed, ei, ej, S_ji, torch.ones(len(pairs), dtype=torch.bool, device=dev)), \
        dict(n_iters=20, lambda_init=1e-16, fix_scale=False)


def refine_inputs(dev, N=1024, n_valid=256, seed=1):
    """Points seen by two cameras 0.3 m apart, pixel noise 0.5; a start 2 %
    off in scale and 0.02 rad off in rotation."""
    from weiner_slamit_v2_torch.geometry import sim3

    rng = np.random.default_rng(seed)
    X1 = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(1.5, 3, N)].astype(np.float32)
    S21 = sim3.exp(torch.tensor([0.3, 0, 0, 0, 0.05, 0, 0.0]))
    X1t = torch.from_numpy(X1)
    X2t = sim3.apply(S21, X1t)
    Kc = torch.tensor([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    proj = lambda X: (X[:, :2] / X[:, 2:] * 500 + torch.tensor([320.0, 240.0]))  # noqa: E731
    uv1 = proj(X1t) + torch.from_numpy(rng.normal(0, 0.5, (N, 2)).astype(np.float32))
    uv2 = proj(X2t) + torch.from_numpy(rng.normal(0, 0.5, (N, 2)).astype(np.float32))
    S12 = sim3.exp(torch.tensor([0.0, 0, 0, 0.02, 0, 0, 0.02])) @ sim3.inv(S21)
    valid = torch.arange(N) < n_valid
    w = torch.ones(N)
    args = [S12, X1t, X2t, valid, uv1, uv2, w, w, Kc]
    return [a.to(dev) for a in args], dict(n_iters=10, chi2_th=10.0, fix_scale=False)


def host_bottom_row():
    """Swap se3.from_rt for its earlier form, whose bottom row is a host
    list copied to the device on every call."""
    from weiner_slamit_v2_torch.geometry import se3

    def from_rt(R, t):
        batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
        top = torch.cat([R.expand(*batch, 3, 3), t.expand(*batch, 3)[..., None]], -1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
        return torch.cat([top, bottom.expand(*batch, 1, 4)], -2)

    se3.from_rt = from_rt


def measure(name, fn, out):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    try:
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
            with torch.cuda.graph(g, stream=s):
                fn()
        torch.cuda.current_stream().wait_stream(s)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reps = []
        for _ in range(3):
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            reps.append(a.elapsed_time(b))
        graph = f"{np.median(reps):.3f} ms (graph replay, median of 3)"
    except RuntimeError as e:
        torch.cuda.synchronize()
        graph = f"not capturable: {str(e).splitlines()[0]}"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    calls = {e.key: e.count for e in ka}
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type.name == "CUDA")
    n_kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    h2d = sum(c for k, c in calls.items() if k.startswith("cudaMemcpy"))
    print(f"{name}: host {np.median(host):.3f} ms synchronized (median of 3: {[round(h, 3) for h in host]}); "
          f"device {graph}; under the profiler {wall:.3f} ms wall, device busy {dev_us / 1e3:.3f} ms "
          f"(share {dev_us / 1e3 / wall:.3f}), device activities {n_kernels}, cudaLaunchKernel "
          f"{calls.get('cudaLaunchKernel', 0)}, cudaMemcpy* {h2d}, cudaStreamSynchronize "
          f"{calls.get('cudaStreamSynchronize', 0)}", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12))
    if out:
        out.write(f"== {name}\n" + ka.table(sort_by="self_device_time_total", row_limit=60)
                  + ka.table(sort_by="self_cpu_time_total", row_limit=60))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host-bottom-row", action="store_true",
                    help="the earlier se3.from_rt: its bottom row copied from the host per call")
    ap.add_argument("--out", default=None, help="write the full profiler tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess

    import weiner_slamit_v2_torch  # noqa: F401  (sets the TF32-off policy)
    from weiner_slamit_v2_torch.optim.pose_graph import optimize_pose_graph
    from weiner_slamit_v2_torch.optim.sim3_solver import refine_sim3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}; from_rt bottom row "
          f"{'from a host list' if args.host_bottom_row else 'made on the device'}")
    if args.host_bottom_row:
        host_bottom_row()
    dev = torch.device("cuda", 0)
    out = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        out = open(args.out, "w")
    gargs, gkw = graph_inputs(dev)
    measure("optimize_pose_graph (256 slots, 42 valid, 198 edges, 20 LM steps)",
            lambda: optimize_pose_graph(*gargs, **gkw), out)
    rargs, rkw = refine_inputs(dev)
    measure("refine_sim3 (1024 match slots, 256 valid, 10 GN steps)",
            lambda: refine_sim3(*rargs, **rkw), out)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
