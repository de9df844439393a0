"""Mapping passes adopted (System.mapping_passes) per 100 frames of the
window."""


def read(ctx):
    return 100.0 * ctx.passes / ctx.frames if ctx.frames else None
