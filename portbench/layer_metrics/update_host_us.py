"""Host microseconds of one ``update`` call (the collection's entry, or the
fused handle behind it), the mean over the measured window's calls: the
benchmark's own ``perf_counter`` span around each call."""


def read(ctx):
    spans = ctx.window_update_s
    return sum(spans) / len(spans) * 1e6 if spans else None
