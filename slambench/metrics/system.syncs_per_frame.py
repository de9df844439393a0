"""Host calls that wait for the card (cudaStreamSynchronize,
cudaEventSynchronize, synchronous cudaMemcpy) per traced frame, from the
profiler's trace; the benchmark's own span ends are left out."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_frames:
        return None
    return ctx.trace["syncs"] / ctx.traced_frames
