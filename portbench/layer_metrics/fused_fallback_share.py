"""Share of member updates that the fused update ran eagerly instead of in
its graph (``core/fused.py``), over the traced passes: the program's
recorder counters ``fused_update_totals()``."""


def read(ctx):
    totals = ctx.fused_totals
    members = totals["fused_metric_updates"] + totals["fallback_metric_updates"]
    if not totals["fused_updates"] or not members:
        return None
    return 100.0 * totals["fallback_metric_updates"] / members
