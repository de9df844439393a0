"""The program's own spans in the profiler trace of the traced frames.

While a span recorder is installed (``weiner_slamit_v2_torch.utils.
profiling``), the program opens a ``torch.profiler.record_function`` range
named ``slam.<layer>.<stage>`` at each layer boundary of a frame (the
frame, its pre-frame adoption, the extraction, the tracking step and its
matches, each pose LM, the host read, a new keyframe, each stage of a
mapping pass, a relocalization). ``harness.py`` installs one around the
traced frames' profiler (``recording``); ``trace.reduce`` accounts for the
spans in its one walk of the events: per span name its calls, and the host
launches, synchronizing calls and device idle seconds whose innermost
``slam.*`` range it is (an idle gap by its middle, as the trace's idle gaps
are attributed), and apart what no ``slam.*`` range holds. So the per-span
launches plus ``launches_unspanned`` are the trace's ``launches``, and
likewise for the synchronizing calls and for the idle time
(``window_s - busy_s``). The readers ``metrics/{frontend.launches_per_extract,
tracker.self_launches_per_step, pose_opt.launches_per_call,
mapping.launches_per_pass, mapping.syncs_per_pass,
device.idle_unspanned_share}.py`` read that account from the Context's
``trace``; ``system.deferred_adoptions_per_100`` reads the growth of
``System.adoptions_deferred`` over the timed window.
"""

from __future__ import annotations

import contextlib

from .trace import PREFIX  # noqa: F401  (the readers' prefix of the program's spans)


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
