"""Host calls that wait for the card per mapping pass: those inside the
program's ``slam.mapping.*`` ranges of the traced frames over the passes
begun in them (as ``mapping.launches_per_pass``); None without a pass
(``spans.py``)."""

from slambench.spans import PREFIX

MAPPING = PREFIX + "mapping."


def read(ctx):
    by = (ctx.trace or {}).get("by_span") or {}
    passes = by.get(MAPPING + "triangulate", {}).get("calls", 0)
    if not passes:
        return None
    return sum(s["syncs"] for n, s in by.items() if n.startswith(MAPPING)) / passes
