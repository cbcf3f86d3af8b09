"""K1's float form at the sketch compactions of every update (the weighted
rows summed by bucket): the bytes per pass (``roofline.segment_sum_f32_bytes``)
over its device time in the traced passes' update spans."""
from portbench import roofline

PATTERN = r"\bsegment_sum_f32_kernel\b"
PHASE = "update"
WORK = "segment_sum_f32.update"


def read(ctx):
    if not ctx.on_card or WORK not in ctx.work or ctx.kind not in roofline.PEAKS:
        return None
    seconds = ctx.trace.device_s(PATTERN, PHASE)
    if seconds <= 0:
        return None
    return roofline.roofline_pct(ctx.work[WORK] * ctx.trace.passes, seconds, ctx.kind)
