"""Polls that found a mapping pass's latency spent but the pass not yet done
on the card (``System.adoptions_deferred``), per 100 frames of the timed
window. None where the program does not count them."""


def read(ctx):
    d = getattr(ctx, "deferred_adoptions", None)
    return 100.0 * d / ctx.frames if d is not None and ctx.frames else None
