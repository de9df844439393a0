"""Percent of the traced frames' wall time in which nothing ran on the card
(no kernel, copy or fill), from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
