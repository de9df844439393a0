"""The port's ordered scatter-adds (weiner_slamit_v2_torch/util.py::index_add)
on one GPU, against the card's atomic ``index_add_``.

    python3 tools/ordered_sums_torch.py probe    # scatter-adds at the global BA's shapes
    python3 tools/ordered_sums_torch.py ab       # chip_smoke.py phase 5: ordered, atomic, atomic, ordered
    python3 tools/ordered_sums_torch.py repeat   # chip_smoke.py phase 12 twice, then phase 14

probe: index_add_, the accumulating index_put_ and _index_put_impl_(unsafe)
into 16,384 x 32 observation rows (6 % of them filled, 45 cameras): whether a
call syncs the host, host enqueue and device time per call, and whether two
runs are equal; once with the empty slots on spare rows (what
local_ba.build_normal_equations does), once all on camera 0, and for the
(point, camera) block U.
ab: chip_smoke.py's phase 5 four times in one process, the BA's and the pose
graph's scatter-adds switched between util.index_add and index_add_; prints
each run's median and p90 ms/frame, then phase 12 once with the ordered sums.
repeat: phase 12 twice in one process (are the sessions equal?), then phase 14
on the second one's map.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe() -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    P, O, C = 16384, 32, 256
    R = P * O
    valid = torch.rand(R, generator=g) < 0.06
    cam = torch.randint(0, 45, (R,), generator=g)
    pidx = torch.arange(P).repeat_interleave(O)
    src36 = (torch.randn(R, 36, generator=g) * valid[:, None]).to(dev)
    src18 = (torch.randn(R, 18, generator=g) * valid[:, None]).to(dev)
    methods = {
        "index_add_": lambda out, i, s: out.index_add_(0, i, s),
        "index_put_": lambda out, i, s: out.index_put_((i,), s, accumulate=True),
        "_index_put_impl_unsafe": lambda out, i, s: torch._index_put_impl_(
            out, (i,), s, accumulate=True, unsafe=True),
    }
    cases = {
        "Hcc spare rows": (C + P, torch.where(valid, cam, C + pidx).to(dev), src36),
        "Hcc camera 0": (C, torch.where(valid, cam, 0).to(dev), src36),
        "U": (P * C, (pidx * C + torch.where(valid, cam, 0)).to(dev), src18),
    }
    for cname, (n, idx, src) in cases.items():
        res = {}
        for mname, fn in methods.items():
            def f():
                return fn(torch.zeros((n, src.shape[1]), device=dev), idx, src)
            a, b = f(), f()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                f()
                sync = "no sync"
            except RuntimeError as e:
                sync = "SYNC: " + str(e).splitlines()[0][:80]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                f()
            host = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                f()
            e1.record()
            torch.cuda.synchronize()
            res[mname] = a
            print(f"{cname:15s} {mname:24s} {sync:40s} host enqueue {host:.3f} ms/call, "
                  f"device {e0.elapsed_time(e1) / 20:.3f} ms/call, two runs equal {torch.equal(a, b)}",
                  flush=True)
        print(f"{cname}: index_put_ == unsafe impl: "
              f"{torch.equal(res['index_put_'], res['_index_put_impl_unsafe'])}, |index_add_ - "
              f"index_put_| {float((res['index_add_'] - res['index_put_']).abs().max()):.3e}", flush=True)


def setup():
    import chip_smoke as cs
    import weiner_slamit_v2_torch  # noqa: F401  (the TF32-off policy)
    from weiner_slamit_v2_torch.ops import cuda_build

    cuda_build.build(cuda_build.sources())
    cuda_build.lib()
    return cs, torch.device("cuda", 0), cs.card_line()


def ab() -> None:
    from weiner_slamit_v2_torch import util
    from weiner_slamit_v2_torch.optim import local_ba, pose_graph

    cs, dev, card = setup()

    def atomic(out, i, s):
        return out.index_add_(0, i, s)

    for name in ("ordered", "atomic", "atomic", "ordered"):
        local_ba.index_add = pose_graph.index_add = util.index_add if name == "ordered" else atomic
        t0 = time.perf_counter()
        cs.phase_slice(dev, card)
        cs.log(f"A/B {name}: phase 5 {time.perf_counter() - t0:.1f} s, median "
               f"{cs.SLICE_MS['median']:.3f} p90 {cs.SLICE_MS['p90']:.3f} ms/frame")
    local_ba.index_add = pose_graph.index_add = util.index_add
    t0 = time.perf_counter()
    cs.phase_loop(dev, card)
    cs.log(f"phase 12 ordered: {time.perf_counter() - t0:.1f} s")


def repeat() -> None:
    cs, dev, card = setup()
    lines, log = [], cs.log

    def keep(msg):
        lines.append(msg)
        log(msg)

    cs.log = keep
    runs = []
    for k in range(2):
        t0 = time.perf_counter()
        lines.clear()
        try:
            cs.phase_loop(dev, card)
            ok = True
        except AssertionError as e:
            ok = False
            keep(f"run {k}: phase 12 failed: {e}"[:3000])
        runs.append(next(m for m in lines if m.startswith("loop: {")))
        keep(f"run {k}: ok {ok}, {time.perf_counter() - t0:.1f} s")
    keep(f"phase 12 runs identical: {runs[0] == runs[1]}")
    t0 = time.perf_counter()
    cs.phase_gba(dev, card)
    keep(f"phase 14: {time.perf_counter() - t0:.1f} s")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what not in ("probe", "ab", "repeat"):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    {"probe": probe, "ab": ab, "repeat": repeat}[what]()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
