"""Share of the traced passes' window in which no operation ran on the
card: the profiler's trace."""


def read(ctx):
    if not ctx.on_card or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
