"""Percent of the card's idle time in the traced frames that falls in no
program span (a gap by its middle, ``spans.py``): the idle time the
program's spans do not account for. None where the trace holds no program
span."""


def read(ctx):
    t = ctx.trace or {}
    idle = t.get("window_s", 0.0) - t.get("busy_s", 0.0)
    if not t.get("by_span") or idle <= 0:
        return None
    return 100.0 * t["idle_unspanned_s"] / idle
