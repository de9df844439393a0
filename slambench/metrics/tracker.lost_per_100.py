"""Frames that ended LOST per 100 frames of the window (covered frames and
failed relocalizations)."""


def read(ctx):
    return 100.0 * ctx.lost / ctx.frames if ctx.frames else None
