"""Mean ms of the tracking step of a frame in the OK state (motion match,
pose LM, local-map match, pose LM, keyframe decision and creation), host
clock, card synchronized."""


def read(ctx):
    return ctx.span_mean_ms("tracker.track")
