"""Launches per tracking step outside its two pose LMs: those whose innermost
program span is ``slam.tracker.step`` or one of its matches and its tail
(the step's ``slam.pose_opt.optimize_pose`` ranges are left out), over the
traced frames' steps (``spans.py``)."""

STEP = "slam.tracker.step"
PARTS = (STEP, "slam.tracker.motion_match", "slam.tracker.refkf_match", "slam.tracker.local_map",
         "slam.tracker.step_tail")


def read(ctx):
    by = (ctx.trace or {}).get("by_span") or {}
    steps = by.get(STEP, {}).get("calls", 0)
    return sum(by.get(n, {}).get("launches", 0) for n in PARTS) / steps if steps else None
