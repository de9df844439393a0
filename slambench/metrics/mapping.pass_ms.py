"""Mean ms of one fused mapping pass (mapping_step: cull, triangulate, fuse
with kernel B, local BA), host clock, card synchronized."""


def read(ctx):
    return ctx.span_mean_ms("mapping.mapping_step")
