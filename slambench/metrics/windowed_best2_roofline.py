"""Kernel B's share of its roofline: the least time of its traced calls (the
bytes of each fuse call's rows and columns, or its gate and distance
operations if more) over their device time, against the published H100
peaks."""

from slambench import roofline


def read(ctx):
    calls = (ctx.trace or {}).get("kernel_calls", {}).get("windowed_best2_kernel")
    if not calls or len(calls) != len(ctx.traced_fuses):
        return None
    least = sum(roofline.best2_call_seconds(args, th) for args, th in ctx.traced_fuses)
    return 100.0 * least / sum(calls)
