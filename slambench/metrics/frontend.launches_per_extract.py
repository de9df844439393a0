"""Kernel and graph launches from the host per extraction (pyramid, kernel A,
selection, orientation, BRIEF, undistortion): those inside the program's
``slam.frontend.extract`` ranges of the traced frames over their number
(``spans.py``)."""


def read(ctx):
    s = ((ctx.trace or {}).get("by_span") or {}).get("slam.frontend.extract")
    return s["launches"] / s["calls"] if s and s["calls"] else None
