"""Mean ms of one relocalization call (BoW candidates, PnP, pose LMs and
projection retries), host clock, card synchronized."""


def read(ctx):
    return ctx.span_mean_ms("tracker.relocalize")
