"""Kernel A's share of its roofline: the least time of its calls (8 B and
127 operations a pixel of the pyramid) over their device time in the trace,
against the published H100 peaks."""

from slambench import roofline


def read(ctx):
    calls = (ctx.trace or {}).get("kernel_calls", {}).get("fast_score_nms_levels_kernel")
    if not calls:
        return None
    return 100.0 * len(calls) * roofline.fast_call_seconds(ctx.level_shapes) / sum(calls)
