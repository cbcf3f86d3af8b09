"""K1's count form (``bincount_i32``, ``csrc/segment_sum.cu``) at the confusion
matrix's updates: the bytes its work needs per pass (``roofline.bincount_i32_bytes``)
over its device time in the traced passes' update spans, against the card's
peak bandwidth."""
from portbench import roofline

PATTERN = r"\bbincount_i32_kernel\b"
PHASE = "update"
WORK = "bincount_i32.update"


def read(ctx):
    if not ctx.on_card or WORK not in ctx.work or ctx.kind not in roofline.PEAKS:
        return None
    seconds = ctx.trace.device_s(PATTERN, PHASE)
    if seconds <= 0:
        return None
    return roofline.roofline_pct(ctx.work[WORK] * ctx.trace.passes, seconds, ctx.kind)
