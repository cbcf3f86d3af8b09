"""K3 (``qsketch_sort_bucket``, ``csrc/qsketch.cu``: its five kernels) at the
sketch compactions of every update: the bytes the compactions need per pass
(``roofline.qsketch_sort_bucket_bytes``) over its device time in the traced
passes' update spans."""
from portbench import roofline

PATTERN = r"\b(sort_tiles_kernel|merge_pass_kernel|tile_sums_kernel|scan_bucket_kernel|gather_rows_kernel)\b"
PHASE = "update"
WORK = "qsketch_sort_bucket.update"


def read(ctx):
    if not ctx.on_card or WORK not in ctx.work or ctx.kind not in roofline.PEAKS:
        return None
    seconds = ctx.trace.device_s(PATTERN, PHASE)
    if seconds <= 0:
        return None
    return roofline.roofline_pct(ctx.work[WORK] * ctx.trace.passes, seconds, ctx.kind)
