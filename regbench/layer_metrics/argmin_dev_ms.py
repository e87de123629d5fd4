"""``argmin_dev_ms``: the card's milliseconds a (setting, pair) case of the
program's ``convex.coupled`` spans (the coupled convex argmin: the box pass
of the initial pick, the six couplings and their box passes, both
directions), each the stream time between the span's two CUDA events, read
from the record the sweep returns on ``SweepResult.spans``
(``utils/trace.py``), summed over the window's calls.  The spans hold the
argmin's launches only (the displacement mesh, whose copy waits for the
queue, is made before them); the stream's idle stretches between those
launches count.  Nothing where a call returned no such span, or one without
a stream time (off the card)."""


def read(ctx):
    total = 0.0
    for _, _, res in ctx.calls:
        spans = [s for s in getattr(res, "spans", None) or () if s.name == "convex.coupled"]
        if not spans or any(s.stream_ms is None for s in spans):
            return None
        total += sum(s.stream_ms for s in spans)
    return total / ctx.cases if ctx.cases else None
