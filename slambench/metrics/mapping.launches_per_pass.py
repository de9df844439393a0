"""Launches per mapping pass: those inside the program's ``slam.mapping.*``
ranges of the traced frames (the pass and its cull, triangulation, fuse,
stats refresh, BA extraction, BA and finish) over the passes begun in them
(each pass triangulates once, fused or staged); None without a pass
(``spans.py``)."""

from slambench.spans import PREFIX

MAPPING = PREFIX + "mapping."


def read(ctx):
    by = (ctx.trace or {}).get("by_span") or {}
    passes = by.get(MAPPING + "triangulate", {}).get("calls", 0)
    if not passes:
        return None
    return sum(s["launches"] for n, s in by.items() if n.startswith(MAPPING)) / passes
