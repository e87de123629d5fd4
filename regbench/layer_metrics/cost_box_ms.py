"""``cost_box_ms``: the card's milliseconds a case of the program's
``convex.box`` spans (the cost volume's zero-padded 3^3 box passes of both
directions, and of every block a streamed direction makes again), each the
stream time between the span's two CUDA events, read from the record each
call returns (``spans``, ``utils/trace.py``), summed over the window's
calls.  Nothing where a call returned no such span (a program without it),
or one without a stream time (off the card)."""


def read(ctx):
    total = 0.0
    for _, _, res in ctx.calls:
        spans = [s for s in getattr(res, "spans", None) or () if s.name == "convex.box"]
        if not spans or any(s.stream_ms is None for s in spans):
            return None
        total += sum(s.stream_ms for s in spans)
    return total / ctx.cases if ctx.cases else None
