"""K1's float form (``segment_sum_f32``, the ordered body) at compute's rank
sums: the bytes its work needs per pass (``roofline.segment_sum_f32_bytes``)
over its device time in the traced passes' compute spans."""
from portbench import roofline

PATTERN = r"\bsegment_sum_f32_kernel\b"
PHASE = "compute"
WORK = "segment_sum_f32.compute"


def read(ctx):
    if not ctx.on_card or WORK not in ctx.work or ctx.kind not in roofline.PEAKS:
        return None
    seconds = ctx.trace.device_s(PATTERN, PHASE)
    if seconds <= 0:
        return None
    return roofline.roofline_pct(ctx.work[WORK] * ctx.trace.passes, seconds, ctx.kind)
