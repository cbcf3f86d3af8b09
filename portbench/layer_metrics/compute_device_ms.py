"""Device milliseconds per pass of every operation launched inside the
benchmark's ``compute`` span (the rank sort and sums, the sketch reads, the
copies of the values to the host): the profiler's trace."""


def read(ctx):
    if not ctx.on_card:
        return None
    seconds = ctx.trace.device_s(phase="compute")
    return seconds / ctx.trace.passes * 1e3 if seconds > 0 else None
