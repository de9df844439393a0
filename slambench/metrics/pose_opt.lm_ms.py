"""Mean ms of one motion-only pose LM (optimize_pose), host clock, card
synchronized."""


def read(ctx):
    return ctx.span_mean_ms("pose_opt.optimize_pose")
