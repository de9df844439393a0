"""The program's own spans in the profiler trace of the traced frames.

While a span recorder is installed (``weiner_slamit_v2_torch.utils.
profiling``), the program opens a ``torch.profiler.record_function`` range
named ``slam.<layer>.<stage>`` at each layer boundary of a frame (the
frame, its pre-frame adoption, the extraction, the tracking step and its
matches, each pose LM, the host read, a new keyframe, each stage of a
mapping pass, a relocalization). ``reduce`` accounts for them: per span
name its calls, and the host launches, synchronizing calls and device idle
seconds whose innermost ``slam.*`` range it is (an idle gap by its middle,
as ``trace.reduce`` attributes gaps), and apart what no ``slam.*`` range
holds. Launches, synchronizing calls, device work and the window are
``trace.py``'s, so the per-span launches plus ``launches_unspanned`` are
``trace.reduce``'s ``launches``, and likewise for the synchronizing calls
and for the idle time (``window_s - busy_s``).

``harness.py`` does not call this module yet. A run reads the program's
spans once the harness enters ``recording()`` just before the traced
frames' profiler starts and leaves it after the profiler stops, merges
``reduce(prof)`` into the Context's ``trace``, logs ``line(...)``, and sets
the Context's ``deferred_adoptions`` to the growth of
``System.adoptions_deferred`` over the timed window; the readers
``metrics/{frontend.launches_per_extract, tracker.self_launches_per_step,
pose_opt.launches_per_call, mapping.launches_per_pass,
mapping.syncs_per_pass, device.idle_unspanned_share,
system.deferred_adoptions_per_100}.py`` read those keys.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

from .trace import DEVICE_KINDS, LAUNCHES, SYNCS, WINDOW_SPAN, _kind, _merge

PREFIX = "slam."


@contextlib.contextmanager
def recording():
    """The program's span recorder, installed for the block; None, and
    nothing installed, where the program has no recorder."""
    from weiner_slamit_v2_torch.utils import profiling

    if not hasattr(profiling, "install"):
        yield None
        return
    rec = profiling.install(profiling.Recorder())
    try:
        yield rec
    finally:
        profiling.uninstall()


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


def reduce(prof) -> dict:
    """``by_span`` ({name: {calls, launches, syncs, idle_s}}, sorted by
    name; empty where the trace holds no ``slam.*`` range),
    ``launches_unspanned``, ``syncs_unspanned`` and ``idle_unspanned_s``
    of the profiled window."""
    events = prof.profiler.kineto_results.events()
    host_ranges = {e.name() for e in events
                   if "CUDA" not in str(e.device_type()) and e.is_user_annotation()}
    dev_iv, spans, launch_t, sync_t = [], [], [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            kind = _kind(e)
            if not (name in host_ranges or (kind and kind not in DEVICE_KINDS)):
                dev_iv.append([e.start_ns(), e.start_ns() + e.duration_ns()])
        elif name.startswith(LAUNCHES):
            launch_t.append(e.start_ns())
        elif name in SYNCS:
            sync_t.append(e.start_ns())
        elif e.is_user_annotation():
            s = e.start_ns()
            if name == WINDOW_SPAN:
                w0, w1 = s, s + e.duration_ns()
            elif name.startswith(PREFIX):
                spans.append((s, s + e.duration_ns(), name))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    busy = [v for s, e in _merge(dev_iv) if e > w0 and s < w1 for v in (max(s, w0), min(e, w1))]
    edges = [w0] + busy + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    spans.sort(key=lambda x: x[0])
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


def line(red: dict, summary: dict | None = None) -> str:
    """One line of the account: per span its calls, then a call's launches,
    synchronizing calls and device idle ms, and with the recorder's
    ``summary()`` a call's host ms (total / self), taken under the
    profiler; then what no span holds."""
    parts = []
    for name, s in red["by_span"].items():
        n = max(s["calls"], 1)
        host = (summary or {}).get(name)
        parts.append(f"{name} {s['calls']} x ({s['launches'] / n:.1f} launches, "
                     f"{s['syncs'] / n:.2f} syncs, {1e3 * s['idle_s'] / n:.2f} idle ms"
                     + (f", host {host['total_ms'] / n:.2f} / {host['self_ms'] / n:.2f} ms"
                        if host else "") + ")")
    return ("program spans over the traced frames (a call's launches, syncs, device idle ms; "
            "host ms total / self, under the profiler): " + "; ".join(parts)
            + f"; in no span: {red['launches_unspanned']} launches, {red['syncs_unspanned']} "
              f"syncs, {red['idle_unspanned_s']:.4f} s idle")
