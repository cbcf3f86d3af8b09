"""Synchronising CUDA calls per ``update`` call (value checks' host reads,
intake copies): the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
raised inside the traced passes' update calls, over those calls. Read on
the card only."""


def read(ctx):
    if ctx.sync_warnings is None or not ctx.traced_updates:
        return None
    return ctx.sync_warnings / ctx.traced_updates
