"""Launches per motion-only pose LM (``optimize_pose``: 4 x 10 iterations,
on the card one launch of the pose LM's kernel a call): those inside the
program's ``slam.pose_opt.optimize_pose`` ranges of the traced frames over
their number (``spans.py``)."""


def read(ctx):
    s = ((ctx.trace or {}).get("by_span") or {}).get("slam.pose_opt.optimize_pose")
    return s["launches"] / s["calls"] if s and s["calls"] else None
