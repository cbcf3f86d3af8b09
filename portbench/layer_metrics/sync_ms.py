"""Host milliseconds per pass that the members' state syncs took inside
``compute()`` (``parallel/distributed.py``'s gathers): the program's own
``<Metric>.sync`` spans, recorded while its recorder was on, over the
traced passes. Only a run of more than one rank syncs."""


def read(ctx):
    if ctx.world < 2:
        return None
    ms = [e["dur_ms"] for e in ctx.recorder_events if e.get("type") == "span" and str(e.get("name", "")).endswith(".sync")]
    return sum(ms) / ctx.trace.passes if ms else None
