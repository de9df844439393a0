"""Reduction of a ``torch.profiler`` trace of the traced frames to counts and
times: device busy time (the union of every kernel, copy and fill on the
card), host launches and synchronizing calls, kernel time by name, the
device's idle gaps attributed to the innermost host span they fell in, and
the account of the program's own ``slam.*`` spans (``spans.py``): per span
name its calls, and the launches, synchronizing calls and idle seconds
whose innermost ``slam.*`` range it is, and apart what no such range holds.

The raw kineto events are read directly (``kineto_results.events()``),
without building the profiler's Python event tree, and walked once, so that
a trace of some hundred thousand launches reduces in seconds.
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
PREFIX = "slam."     # the program's own spans
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


def _innermost(times, spans):
    """For each of the ascending ``times``, the name of the shortest of the
    ``spans`` (start, end, name), sorted by start, that holds it; None
    where none does."""
    nxt, active = 0, []
    for t in times:
        while nxt < len(spans) and spans[nxt][0] <= t:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] >= t]
        yield min(active, key=lambda sp: sp[1] - sp[0])[2] if active else None


def _account(spans, launch_t, sync_t, gaps) -> dict:
    """The program spans' account: ``by_span`` ({name: {calls, launches,
    syncs, idle_s}}, sorted by name), ``launches_unspanned``,
    ``syncs_unspanned``, ``idle_unspanned_s``."""
    spans = [sp for sp in spans if sp[2].startswith(PREFIX)]
    acc = defaultdict(lambda: {"calls": 0, "launches": 0, "syncs": 0, "idle_s": 0.0})
    for _, _, name in spans:
        acc[name]["calls"] += 1
    for key, times in (("launches", launch_t), ("syncs", sync_t)):
        for name in _innermost(sorted(times), spans):
            acc[name][key] += 1
    for (g0, g1), name in zip(gaps, _innermost([0.5 * (g0 + g1) for g0, g1 in gaps], spans)):
        acc[name]["idle_s"] += (g1 - g0) * 1e-9
    out = acc.pop(None, {"launches": 0, "syncs": 0, "idle_s": 0.0})
    return dict(by_span=dict(sorted(acc.items())), launches_unspanned=out["launches"],
                syncs_unspanned=out["syncs"], idle_unspanned_s=out["idle_s"])


def reduce(prof) -> dict:
    """Counts and times of the profiled window (the ``WINDOW_SPAN`` range),
    with the program spans' account (``_account``), from one walk of the
    events."""
    host_ranges, device, spans, launch_t, sync_t = set(), [], [], [], []
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "CUDA" in str(e.device_type()):
            kind = _kind(e)
            if not kind or kind in DEVICE_KINDS:
                device.append((name, e.start_ns(), e.duration_ns()))
        elif name.startswith(LAUNCHES):
            launch_t.append(e.start_ns())
        elif name in SYNCS:
            sync_t.append(e.start_ns())
        elif e.is_user_annotation():
            host_ranges.add(name)
            s, d = e.start_ns(), e.duration_ns()
            if name == WINDOW_SPAN:
                w0, w1 = s, s + d
            else:
                spans.append((s, s + d, name))
    # the host spans (record_function) are mirrored on the device's timeline
    # under the same names: those are no device work
    dev_iv = []
    by_kernel = defaultdict(float)
    kernel_calls = defaultdict(list)
    for name, s, d in device:
        if name in host_ranges:
            continue
        dev_iv.append([s, s + d])
        by_kernel[name] += d * 1e-9
        for k in (KERNEL_A, KERNEL_B):
            if k in name:
                kernel_calls[k].append((s, d * 1e-9))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    busy_iv = [[max(s, w0), min(e, w1)] for s, e in _merge(dev_iv) if e > w0 and s < w1]
    busy_s = sum(e - s for s, e in busy_iv) * 1e-9
    # idle gaps, each by the innermost host span covering its middle
    by_gap = defaultdict(float)
    spans.sort(key=lambda x: x[0])
    edges = [w0] + [v for iv in busy_iv for v in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    for (g0, g1), inner in zip(gaps, _innermost([0.5 * (g0 + g1) for g0, g1 in gaps], spans)):
        by_gap[inner or "harness"] += (g1 - g0) * 1e-9
    return dict(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_s, launches=len(launch_t), syncs=len(sync_t),
        device_ops=[(k[:NAME_CHARS], v) for k, v in sorted(by_kernel.items(),
                                                           key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP],
        kernel_calls={k: [d for _, d in sorted(v)] for k, v in kernel_calls.items()},
        **_account(spans, launch_t, sync_t, gaps),
    )
