"""Kernel and graph launches from the host per traced frame, from the
profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_frames:
        return None
    return ctx.trace["launches"] / ctx.traced_frames
