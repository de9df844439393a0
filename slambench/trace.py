"""Reduction of a ``torch.profiler`` trace of the traced frames to counts and
times: device busy time (the union of every kernel, copy and fill on the
card), host launches and synchronizing calls, kernel time by name, and the
device's idle gaps attributed to the innermost host span they fell in.

The raw kineto events are read directly (``kineto_results.events()``),
without building the profiler's Python event tree, so that a trace of some
hundred thousand launches reduces in seconds.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW_SPAN = "slambench.traced_frames"
# host calls that launch work on the card, and those that wait for it. The
# benchmark's own spans synchronize with cudaDeviceSynchronize, which is
# therefore left out of the program's count
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaGraphLaunch", "cudaLaunchCooperativeKernel")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
KERNEL_A = "fast_score_nms_levels_kernel"
KERNEL_B = "windowed_best2_kernel"
TOP = 10
NAME_CHARS = 96     # a device operation's name is cut to this many characters


def _kind(e) -> str:
    at = getattr(e, "activity_type", None)
    return str(at()) if at is not None else ""


def _merge(iv: list) -> list:
    iv.sort()
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """Counts and times of the profiled window (the ``WINDOW_SPAN`` range)."""
    events = prof.profiler.kineto_results.events()
    # the host spans (record_function) are mirrored on the device's timeline
    # under the same names: those are no device work
    host_ranges = {e.name() for e in events
                   if "CUDA" not in str(e.device_type()) and e.is_user_annotation()}
    dev_iv, spans = [], []
    by_kernel = defaultdict(float)
    kernel_calls = defaultdict(list)
    launches = syncs = 0
    w0 = w1 = None
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            kind = _kind(e)
            if name in host_ranges or (kind and kind not in DEVICE_KINDS):
                continue
            s, d = e.start_ns(), e.duration_ns()
            dev_iv.append([s, s + d])
            by_kernel[name] += d * 1e-9
            for k in (KERNEL_A, KERNEL_B):
                if k in name:
                    kernel_calls[k].append((s, d * 1e-9))
            continue
        if name.startswith(LAUNCHES):
            launches += 1
        elif name in SYNCS:
            syncs += 1
        elif e.is_user_annotation():
            s, d = e.start_ns(), e.duration_ns()
            if name == WINDOW_SPAN:
                w0, w1 = s, s + d
            else:
                spans.append((s, s + d, name))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    busy_iv = [[max(s, w0), min(e, w1)] for s, e in _merge(dev_iv) if e > w0 and s < w1]
    busy_s = sum(e - s for s, e in busy_iv) * 1e-9
    # idle gaps, each by the innermost host span covering its middle
    gaps = defaultdict(float)
    spans.sort(key=lambda x: x[0])
    edges = [w0] + [v for iv in busy_iv for v in iv] + [w1]
    nxt, active = 0, []
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] >= mid]
        inner = min(active, key=lambda sp: sp[1] - sp[0])[2] if active else "harness"
        gaps[inner] += (g1 - g0) * 1e-9
    return dict(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_s, launches=launches, syncs=syncs,
        device_ops=[(k[:NAME_CHARS], v) for k, v in sorted(by_kernel.items(),
                                                           key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
        kernel_calls={k: [d for _, d in sorted(v)] for k, v in kernel_calls.items()},
    )
