"""Mean ms of the tracker's extraction (pyramid, kernel A, selection,
orientation, BRIEF, undistortion) per call, host clock, card synchronized."""


def read(ctx):
    return ctx.span_mean_ms("frontend.extract")
